"""Hyperparameters and model dimensions.

The same dataclasses, names and defaults as ``bayesfmmm_tpu.config``
(defaults from UserFunctions.cpp:176-193 / :700).  They are restated here,
not imported, so that the port loads nothing of the JAX package on a
machine that has no JAX; ``tests/test_torch_state.py`` holds the two
definitions equal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Priors:
    """Hyperparameters of the mixed-membership model priors."""
    b: float = 10.0                # exponential prior rate on alpha_3
    nu_1: float = 3.0              # t-dof of the gamma (local scale) prior
    alpha1l: float = 1.0           # MGP a1 gamma prior shape
    alpha2l: float = 2.0           # MGP a2 gamma prior shape
    beta1l: float = 1.0
    beta2l: float = 1.0
    a_Z_PM: float = 10000.0        # Dirichlet proposal concentration for Z
    a_pi_PM: float = 1000.0        # Dirichlet proposal concentration for pi
    var_alpha3: float = 0.05       # truncnorm proposal sd for alpha_3
    var_epsilon1: float = 1.0      # truncnorm proposal scales for A (MH)
    var_epsilon2: float = 1.0
    alpha_nu: float = 10.0         # tau ~ Gamma(alpha_nu, beta_nu)
    beta_nu: float = 1.0
    alpha_eta: float = 10.0        # tau_eta ~ Gamma(alpha_eta, beta_eta)
    beta_eta: float = 1.0
    alpha_0: float = 1.0           # sigma^2 ~ IG(alpha_0, beta_0)
    beta_0: float = 1.0
    c: tuple | None = None         # Dirichlet prior on pi; default 10*1_K

    def c_vector(self, K: int):
        """The Dirichlet prior vector on pi as a host array of K entries
        (UserFunctions.cpp:272-288)."""
        if self.c is None:
            return np.full(K, 10.0)
        c = np.asarray(self.c, dtype=float)
        if c.shape != (K,):
            raise ValueError("number of elements of the vector 'c' must be "
                             "equal to K")
        if np.any(c <= 0):
            raise ValueError("all elements of 'c' must be positive")
        return c

    def validate(self) -> "Priors":
        for name in ("b", "nu_1", "alpha1l", "alpha2l", "beta1l", "beta2l",
                     "a_Z_PM", "a_pi_PM", "var_alpha3", "var_epsilon1",
                     "var_epsilon2", "alpha_nu", "beta_nu", "alpha_eta",
                     "beta_eta", "alpha_0", "beta_0"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive "
                                 f"(reference: UserFunctions.cpp:198-286)")
        return self


@dataclass(frozen=True)
class ModelConfig:
    """Dimensions and family flags of a mixed-membership model."""
    K: int                         # number of features/clusters
    P: int                         # basis dimension (or data dim for MV)
    M: int                         # pseudo-eigenfunction truncation
    D: int = 0                     # number of covariates (0 = plain model)
    family: str = "functional"
    covariate_mean: bool = False   # eta terms active
    covariate_cov: bool = False    # xi terms active

    def __post_init__(self):
        if self.K < 2:
            raise ValueError("K must be at least 2")
        if self.M < 1 or self.P < 1:
            raise ValueError("P and M must be positive")
        if self.family not in ("functional", "hd", "multivariate"):
            raise ValueError(f"unknown family {self.family!r}")
        if (self.covariate_mean or self.covariate_cov) and self.D == 0:
            raise ValueError("covariate adjustment requires D > 0")
        if self.covariate_cov and not self.covariate_mean:
            raise ValueError("covariate_cov requires covariate_mean")


@dataclass(frozen=True)
class SamplerConfig:
    """MCMC driver knobs (warm_start defaults: UserFunctions.cpp:1353-1359)."""
    tot_mcmc_iters: int = 1000
    r_stored_iters: int | None = None   # batch/ring size; None = keep all
    thinning_num: int = 1
    burnin_prop: float = 0.8
    n_try: int = 1                      # restarts (multi-chain best-of)
    n_chains: int = 4                   # parallel chains (the chain axis)
    # Tempered transitions (BFMMM.h:1451-1460)
    beta_N_t: float = 1.0               # coldest ladder temperature
    N_t: int = 1                        # ladder half-length
    n_temp_trans: int = 0               # 0 = disabled
    seed: int = 0

    def __post_init__(self):
        if not (0.0 <= self.burnin_prop < 1.0):
            raise ValueError("burnin_prop must be in [0, 1)")
        if self.thinning_num < 1 or self.tot_mcmc_iters < 1:
            raise ValueError("iteration counts must be positive")
        if self.beta_N_t <= 0 or self.beta_N_t > 1:
            raise ValueError("beta_N_t must be in (0, 1]")


def replace(cfg, **kw):
    """A copy of the frozen dataclass ``cfg`` with the fields ``kw``."""
    return dataclasses.replace(cfg, **kw)
