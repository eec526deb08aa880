"""Argument validation with reference-parity error messages.

The reference validates ~25 preconditions per fitting entry point with
specific ``Rcpp::stop`` messages (UserFunctions.cpp:196-290 for Nu_Z,
:718-790 for Theta, :1393-1545 for warm_start) and guards every
post-processing call (PostProcessing.cpp:115-151 and the per-function
repeats).  These helpers reproduce the same conditions and messages so a
reference user sees identical diagnostics.

The port's own copy of ``bayesfmmm_tpu/validation.py`` (NumPy only), so that
it loads nothing of the JAX package; ``tests/test_torch_api.py`` holds the
two equal, message for message.
"""

from __future__ import annotations

import numpy as np

__all__ = ["validate_fit_args", "validate_knots", "validate_hd_knots",
           "validate_c", "validate_warm_start_args",
           "validate_postprocess_args", "validate_k", "validate_x_columns"]


def validate_fit_args(*, tot_mcmc_iters=None, n_try=None, K=None,
                      n_funct=None, basis_degree=None, n_eigen=None,
                      burnin_prop=None):
    """Common fitting preconditions (UserFunctions.cpp:198-222, :725-741)."""
    if tot_mcmc_iters is not None and tot_mcmc_iters < 100:
        raise ValueError("'tot_mcmc_iters' must be an integer greater than "
                         "or equal to 100")
    if n_try is not None and n_try < 1:
        raise ValueError("'n_try' must be an integer greater than or equal "
                         "to 1")
    if K is not None and K < 2:
        raise ValueError("'K' must be an integer greater than or equal to 2")
    if n_funct is not None and n_funct < 1:
        raise ValueError("'n_funct' must be an integer greater than or "
                         "equal to 1")
    if basis_degree is not None and basis_degree < 1:
        raise ValueError("'basis_degree' must be an integer greater than or "
                         "equal to 1")
    if n_eigen is not None and n_eigen < 1:
        raise ValueError("'n_eigen' must be an integer greater than or "
                         "equal to 1")
    if burnin_prop is not None and not (0.0 <= burnin_prop < 1.0):
        raise ValueError("'burnin_prop' must be between 0 and 1")


def validate_knots(internal_knots, boundary_knots):
    """UserFunctions.cpp:219-227 / PostProcessing.cpp:136-142."""
    if internal_knots is None or boundary_knots is None:
        raise ValueError("'internal_knots' and 'boundary_knots' are "
                         "required for the functional family")
    bk = np.asarray(boundary_knots, dtype=float).ravel()
    if bk.size != 2:
        raise ValueError("'boundary_knots' must contain exactly two knots")
    for kn in np.asarray(internal_knots, dtype=float).ravel():
        if bk[0] >= kn:
            raise ValueError("at least one element in 'internal_knots' is "
                             "less than or equal to first boundary knot")
        if bk[1] <= kn:
            raise ValueError("at least one element in 'internal_knots' is "
                             "more than or equal to second boundary knot")


def validate_hd_knots(basis_degrees, internal_knots_list, boundary_knots):
    """HD (tensor) variants validate per dimension
    (UserFunctions.cpp HD mirrors; PostProcessing.cpp:838-851)."""
    if basis_degrees is None or internal_knots_list is None \
            or boundary_knots is None:
        raise ValueError("'basis_degree', 'internal_knots' and "
                         "'boundary_knots' are required for the hd family")
    degrees = np.asarray(basis_degrees).ravel()
    if np.any(degrees < 1):
        raise ValueError("'basis_degree' elements must be an integer "
                         "greater than or equal to 1")
    bk = np.asarray(boundary_knots, dtype=float)
    if bk.ndim == 1:
        bk = np.tile(bk, (len(degrees), 1))
    for d in range(len(degrees)):
        validate_knots(internal_knots_list[d], bk[d])


def validate_c(c, K):
    """UserFunctions.cpp:278-288."""
    c = np.asarray(c, dtype=float).ravel()
    if c.shape[0] != K:
        raise ValueError("number of elements of the vector 'c' must be "
                         "equal to K")
    if np.any(c <= 0):
        raise ValueError("all elements of 'c' must be positive")


def validate_warm_start_args(*, thinning_num=1, beta_N_t=1.0, N_t=1,
                             r_stored_iters=None, n_temp_trans=0,
                             tot_mcmc_iters=None, directory=None):
    """warm_start storage/tempering knobs (UserFunctions.cpp:1472-1541)."""
    if thinning_num <= 0:
        raise ValueError("'thinning_num' must be a positive integer")
    if beta_N_t <= 0 or beta_N_t > 1:
        raise ValueError("'beta_N_t' must be between 0 and 1")
    if N_t < 1:
        raise ValueError("'N_t' must be a positive integer")
    if r_stored_iters is not None and r_stored_iters < 0:
        raise ValueError("'r_stored_iters' must be a non-negative integer")
    if n_temp_trans < 0:
        raise ValueError("'n_temp_trans' must be a non-negative integer")
    if (r_stored_iters is not None and directory is None
            and tot_mcmc_iters is not None
            and r_stored_iters <= tot_mcmc_iters):
        raise ValueError("'r_stored_iters' <= 'tot_mcmc_iters' with no "
                         "'dir' specified. Either specify 'dir' or increase "
                         "'r_stored_iters'")


def validate_postprocess_args(*, n_files=None, alpha=None, burnin_prop=None,
                              basis_degree=None, internal_knots=None,
                              boundary_knots=None):
    """Trace-directory function preconditions (PostProcessing.cpp:115-142)."""
    if n_files is not None and n_files <= 0:
        raise ValueError("'n_files' must be greater than 0")
    if alpha is not None and not (0.0 <= alpha < 1.0):
        raise ValueError("'alpha' must be between 0 and 1")
    if burnin_prop is not None and not (0.0 <= burnin_prop < 1.0):
        raise ValueError("'burnin_prop' must be between 0 and 1")
    if basis_degree is not None:
        degrees = np.asarray(basis_degree).ravel()
        if degrees.size == 1:
            if degrees[0] < 1:
                raise ValueError("'basis_degree' must be an integer greater "
                                 "than or equal to 1")
        elif np.any(degrees < 1):
            raise ValueError("'basis_degree' elements must be an integer "
                             "greater than or equal to 1")
    if internal_knots is not None and boundary_knots is not None:
        bk = np.asarray(boundary_knots, dtype=float)
        if bk.ndim > 1 or (np.asarray(basis_degree).ravel().size > 1
                           if basis_degree is not None else False):
            validate_hd_knots(basis_degree, internal_knots, boundary_knots)
        else:
            validate_knots(internal_knots, boundary_knots)


def validate_k(k, K, name="k"):
    """PostProcessing.cpp:146-151."""
    if k <= 0:
        raise ValueError(f"'{name}' must be positive")
    if k > K:
        raise ValueError(f"'{name}' must be less than or equal to the "
                         "number of clusters in the model")


def validate_x_columns(X, D):
    """PostProcessing.cpp:407."""
    if X is None:
        return
    X = np.atleast_2d(np.asarray(X))
    if X.shape[-1] != D:
        raise ValueError("The number of columns in 'X' must be equal to the "
                         "number of covariates in the model")
