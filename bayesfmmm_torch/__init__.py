"""bayesfmmm-torch: the BayesFMMM mixed-membership sampler in PyTorch.

A port of ``bayesfmmm_tpu`` (JAX) to PyTorch and CUDA.  Every state tensor
carries a leading chain axis C, every updater takes an explicit
``torch.Generator``, and data (B, G, u, y, pen) is shared across chains.
The sweep's three kernels (Cholesky factor-and-solve, mean/RSS, weighted
Gram sums) are hand-written CUDA (``bayesfmmm_torch/csrc``), built with
nvcc at first use and bound with ctypes; on CPU tensors their plain
PyTorch versions run instead.

The package imports nothing of JAX or of ``bayesfmmm_tpu``, so it runs on a
machine that has neither.  It runs on the CUDA card unless told otherwise:
the entry points that build data or state (``simulate_functional``,
``make_functional_data``, ``convert.data_from_jax``,
``convert.state_from_numpy``) place their tensors there when no ``device``
is given and raise without a card; ``device="cpu"`` asks for the CPU.

Quick start (the bench's production sweep; drop the flags for the
reference kernel census)::

    import torch
    from bayesfmmm_torch import ModelConfig, Priors
    from bayesfmmm_torch.models.state import init_state
    from bayesfmmm_torch.samplers import drivers
    from bayesfmmm_torch.utils.simulate import simulate_functional

    data, _ = simulate_functional(seed=7, N=100, K=3, P=8, M=4,
                                  n_time=(100, 100))       # on the card
    g = torch.Generator(device=data.device).manual_seed(0)
    state = init_state(g, ModelConfig(K=3, P=8, M=4), data, chains=256)
    res = drivers.phase_warm_start(
        g, state, data, Priors(), torch.full((3,), 10.0, device=data.device),
        n_iters=500, collapsed_z=True, gauge=True, p_indep=0.3,
        phi_mala_steps=4, phi_mala_step=0.05)
"""

__version__ = "0.1.0"

from bayesfmmm_torch.config import ModelConfig, Priors  # noqa: F401
