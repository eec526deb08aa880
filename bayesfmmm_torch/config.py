"""Hyperparameters and model dimensions.

The same dataclasses, names and defaults as ``bayesfmmm_tpu.config``
(defaults from UserFunctions.cpp:176-193 / :700).  They are restated here,
not imported, so that the port loads nothing of the JAX package on a
machine that has no JAX; ``tests/test_torch_state.py`` holds the two
definitions equal.
"""

from __future__ import annotations

from dataclasses import dataclass


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
