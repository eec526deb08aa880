"""The port's package boundary: no JAX, kernels routed by device, and a
CUDA build that raises instead of falling back."""

import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from bayesfmmm_torch.ops import kernels  # noqa: E402

_IMPORT_ALL = """
import pkgutil, sys, importlib
import bayesfmmm_torch
for m in pkgutil.walk_packages(bayesfmmm_torch.__path__, "bayesfmmm_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "bayesfmmm_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    """Importing every module of the port loads neither JAX nor the JAX
    package, so the port runs on a machine that has no JAX."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cpu_tensors_route_to_plain_versions():
    rng = torch.Generator().manual_seed(0)
    X = torch.randn(4, 7, 7, generator=rng)
    A = X @ X.mT + 7.0 * torch.eye(7)
    b, z = torch.randn(4, 7, generator=rng), torch.randn(4, 7, generator=rng)
    B = torch.randn(5, 6, 3, generator=rng)
    y = torch.randn(5, 6, generator=rng)
    w = torch.randn(2, 5, 3, generator=rng)
    W = torch.rand(3, 5, generator=rng)
    kernels.reset_launch_counts()
    for got, want in zip(kernels.chol_solve(A, b, z),
                         kernels.chol_solve_plain(A, b, z)):
        assert torch.equal(got, want)
    rss, mu = kernels.mean_rss(B, y, w, want_mu=True)
    rss_p, mu_p = kernels.mean_rss_plain(B, y, w, want_mu=True)
    assert torch.equal(rss, rss_p) and torch.equal(mu, mu_p)
    assert kernels.mean_rss(B, y, w)[1] is None
    G = torch.randn(5, 3, 3, generator=rng)
    assert torch.equal(kernels.weighted_gram(W, G),
                       kernels.weighted_gram_plain(W, G))
    assert kernels.LAUNCHES == {"chol_solve": 0, "mean_rss": 0,
                                "weighted_gram": 0}


def test_cuda_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing nvcc is an error at build time, never a silent switch to
    the plain versions."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._library()
    assert not (tmp_path / "build").exists()


def test_chol_solve_max_dim_fits_shared_memory():
    def blocked(D):     # the packed triangle with b as a row, then z
        return 4 * (kernels.packed_row(D + 1) + D)
    top = kernels.chol_solve_max_dim()
    assert blocked(top) <= kernels.SMEM_PER_BLOCK < blocked(top + 1)
    assert top >= 334       # every D the packed kernel served before
    assert top >= 112       # at least the TPU kernel's gate
    assert top >= 256       # the 256-dimensional joint draws have a kernel
    # a square matrix of that side would not fit a block: hence the triangle
    assert 4 * (256 * 256 + 2 * 256) > kernels.SMEM_PER_BLOCK
