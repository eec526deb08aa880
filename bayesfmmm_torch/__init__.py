"""bayesfmmm-torch: the BayesFMMM mixed-membership sampler in PyTorch.

A port of ``bayesfmmm_tpu`` (JAX) to PyTorch and CUDA: the functional, hd
(tensor-product basis) and multivariate (identity basis) families, plain
and covariate-adjusted.  Every state tensor carries a leading chain axis C, every updater takes an explicit
``torch.Generator``, and data (B, G, u, y, pen) is shared across chains.
The sweep's three kernels (Cholesky factor-and-solve, mean/RSS, weighted
Gram sums) are hand-written CUDA (``bayesfmmm_torch/csrc``), built with
nvcc at first use and bound with ctypes; on CPU tensors their plain
PyTorch versions run instead.

The package imports nothing of JAX or of ``bayesfmmm_tpu``, so it runs on a
machine that has neither.  It runs on the CUDA card unless told otherwise:
the entry points that build data or state (``api.build_data``,
``api.fit_nu_z``, ``api.fit``, the simulators of ``utils/simulate.py``, the
data makers of ``models/state.py``, ``convert.data_from_jax``,
``convert.state_from_numpy``) place their tensors there when no ``device``
is given and raise without a card; ``device="cpu"`` asks for the CPU.
``api.fit_theta`` and ``api.fit_warm_start`` (a resume from a checkpoint
too) take the device from the data they are given.

Quick start (the three-phase fit with the bench's production sweep in
phase 3; ``kernels="reference"`` for the reference kernel census)::

    from bayesfmmm_torch import api
    from bayesfmmm_torch.utils.simulate import simulate_functional

    data, _ = simulate_functional(seed=7, N=100, K=3, P=8, M=4,
                                  n_time=(100, 100))       # on the card
    res = api.fit(data=data, K=3, M=4, init="spectral", n_try=7,
                  nu_z_iters=1000, theta_iters=1000, warm_iters=2000,
                  n_chains=256, kernels="production", n_temp_trans=100,
                  N_t=3, beta_N_t=0.5, checkpoint_to="ensemble.npz",
                  directory="traces")
    res.loglik, res.estimates(align=True), res.ensemble_state
    more = api.fit_warm_start(resume_from="ensemble.npz", data=data,
                              tot_mcmc_iters=1000, kernels="production")
"""

__version__ = "0.1.0"

from bayesfmmm_torch.config import ModelConfig, Priors  # noqa: F401
