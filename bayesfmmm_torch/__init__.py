"""bayesfmmm-torch: the BayesFMMM mixed-membership sampler in PyTorch.

A port of ``bayesfmmm_tpu`` (JAX) to PyTorch and CUDA.  Every state tensor
carries a leading chain axis C, every updater takes an explicit
``torch.Generator``, and data (B, G, u, y, pen) is shared across chains.
The two hot kernels of the sweep are hand-written CUDA
(``bayesfmmm_torch/csrc``), built with nvcc at first use and bound with
ctypes; on CPU tensors their plain PyTorch versions run instead.

The package imports nothing of JAX or of ``bayesfmmm_tpu``, so it runs on a
machine that has neither.

Quick start (the reference kernel census of the production sweep)::

    import torch
    from bayesfmmm_torch import ModelConfig, Priors
    from bayesfmmm_torch.models.state import init_state
    from bayesfmmm_torch.samplers import drivers
    from bayesfmmm_torch.utils.simulate import simulate_functional

    data, _ = simulate_functional(seed=7, N=100, K=3, P=8, M=4,
                                  n_time=(100, 100), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    state = init_state(g, ModelConfig(K=3, P=8, M=4), data, chains=256)
    res = drivers.phase_warm_start(g, state, data, Priors(),
                                   torch.full((3,), 10.0, device="cuda"),
                                   n_iters=500)
"""

__version__ = "0.1.0"

from bayesfmmm_torch.config import ModelConfig, Priors  # noqa: F401
