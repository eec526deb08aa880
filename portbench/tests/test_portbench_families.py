"""The benchmark by family: the reference's tensor basis and graph penalty of
the hd family, held to their definitions and to the port's; the checks of a
configuration's family; the functional configurations' data and reference
kept bit for bit; and an hd cell added as files only, run end to end on the
CPU at a small size, ``correct``, and not ``correct`` under every fault it
can have."""

import hashlib
import json
import time

import numpy as np
import pytest

from portbench import datagen, faults, harness, spec
from portbench.reference import bspline, conditionals
from portbench.tests.conftest import (HD_CELLS, HD_CONFIG, HD_CONFIG_NAME,
                                      ROOT, with_hd)

UPSTREAM = dict(degrees=HD_CONFIG["basis_degrees"],
                internal=HD_CONFIG["internal_knots"],
                boundary=HD_CONFIG["boundary_knots"])


def _points(n, boundary, seed=3):
    """n points uniform in the box, its four corners among them."""
    b = np.asarray(boundary, np.float64)
    pts = np.random.default_rng(seed).uniform(b[:, 0], b[:, 1], (n, 2))
    corners = np.array([[b[0, i], b[1, j]] for i in (0, 1) for j in (0, 1)])
    return np.vstack([corners, pts])


def _upstream_design(pts):
    return bspline.tensor_design(pts, UPSTREAM["degrees"],
                                 UPSTREAM["internal"], UPSTREAM["boundary"])


# --- the tensor basis ---------------------------------------------------

def test_tensor_design_rows_sum_to_one():
    B = _upstream_design(_points(200, UPSTREAM["boundary"]))
    assert B.shape == (204, 36) and np.all(B >= 0)
    np.testing.assert_allclose(B.sum(1), 1.0, rtol=0, atol=1e-13)


def test_tensor_design_columns_in_upstreams_order():
    """A 2 x 3 basis (linear by quadratic, no internal knots): column i is
    axis 0's function i // 3 times axis 1's function i % 3, last axis
    fastest, as the multi-indices written out by hand."""
    pts = _points(30, [[0.0, 1.0], [-2.0, 2.0]])
    B = bspline.tensor_design(pts, [1, 2], [[], []], [[0, 1], [-2, 2]])
    B0 = bspline.design(pts[:, 0], 1, [], [0, 1])
    B1 = bspline.design(pts[:, 1], 2, [], [-2, 2])
    order = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert B.shape == (34, 6)
    for col, (i, j) in enumerate(order):
        assert np.array_equal(B[:, col], B0[:, i] * B1[:, j]), col


def test_tensor_design_columns_are_products_of_the_axes():
    pts = _points(100, UPSTREAM["boundary"])
    B = _upstream_design(pts)
    axes = [bspline.design(pts[:, a], UPSTREAM["degrees"][a],
                           UPSTREAM["internal"][a], UPSTREAM["boundary"][a])
            for a in (0, 1)]
    for i in range(6):
        for j in range(6):
            assert np.array_equal(B[:, 6 * i + j], axes[0][:, i] * axes[1][:, j])


# --- the graph penalty --------------------------------------------------

@pytest.mark.parametrize("sizes", [[6, 6], [2, 3], [3, 4, 2]])
def test_tensor_penalty_is_a_graph_laplacian(sizes):
    R = bspline.tensor_penalty(sizes)
    P = int(np.prod(sizes))
    assert R.shape == (P, P)
    assert np.array_equal(R, R.T)
    assert np.array_equal(R.sum(1), np.zeros(P))
    # the null space is the constants: one zero eigenvalue, its vector flat
    w, V = np.linalg.eigh(R)
    assert abs(w[0]) < 1e-12 and w[1] > 1e-6
    np.testing.assert_allclose(np.abs(V[:, 0]), 1 / np.sqrt(P), atol=1e-12)
    # degree of column i: its neighbours on the grid, one an axis and side
    idx = np.stack(np.unravel_index(np.arange(P), sizes), 1)
    degree = sum((idx[:, a] > 0).astype(int) + (idx[:, a] < s - 1)
                 for a, s in enumerate(sizes))
    assert np.array_equal(np.diag(R), degree)


def test_port_hd_data_equals_the_reference():
    """``api.build_data(family="hd")`` on raw points against the reference.
    The port forms its basis in float64 and keeps it in float32, so each
    entry, at most 1, is off by its rounding to float32, at most 2^-25,
    and by the two float64 recursions' round-off, ~1e-16: 2^-24 leaves
    room for both.  The penalty's entries are small integers, exact in
    float32."""
    from bayesfmmm_torch import api
    rng = np.random.default_rng(5)
    t = [_points(n, UPSTREAM["boundary"], seed=i)
         for i, n in enumerate((20, 33, 41))]
    y = [rng.normal(size=len(p)) for p in t]
    data = api.build_data(y, t, family="hd",
                          basis_degrees=UPSTREAM["degrees"],
                          internal_knots_list=UPSTREAM["internal"],
                          boundary_knots=UPSTREAM["boundary"], device="cpu")
    curves = harness.curves_of(dict(family="hd", y=y, t=t, X=None,
                                    **UPSTREAM))
    B = data.B.double().numpy()
    assert B.shape == curves.S.shape
    assert np.max(np.abs(B - curves.S)) <= 2.0 ** -24
    assert np.array_equal(data.pen.double().numpy(), curves.R)


# --- a configuration's family -------------------------------------------

def test_from_config_checks_the_family():
    raw = datagen.from_config(dict(HD_CONFIG, N=4, n_time=[5, 9]), 7)
    assert raw["family"] == "hd" and len(raw["y"]) == 4
    assert all(5 <= len(t) <= 9 and t.shape[1] == 2 for t in raw["t"])
    assert all(np.all((t >= 0) & (t < 990)) for t in raw["t"])
    with pytest.raises(ValueError, match="35"):
        datagen.from_config(dict(HD_CONFIG, P=35), 7)
    with pytest.raises(ValueError, match="multivariate"):
        datagen.from_config(dict(HD_CONFIG, family="multivariate"), 7)
    with pytest.raises(ValueError, match="multivariate"):
        harness.curves_of(dict(raw, family="multivariate"))


# --- the functional configurations keep their bits ----------------------

def _digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


# (data, reference curves, conditionals' design), as the benchmark read
# them before it took a family: functional data keep every bit.
BITS = {
    ("fmm_k3_p8_m4_n100", 2 ** 31 + 7):
        ("88dc2eca6315f710", "ba5f27fafbe513c7", "c4e4852021432b54"),
    ("fmm_k3_p8_m4_n100", 1963300411):
        ("1fa908fdd93c81ac", "9a812465fe63ac1c", "a8cfea814a019da5"),
    ("covcov_k2_p8_m16_d2_n80", 2 ** 31 + 7):
        ("e006441ffe89b1b5", "fa70540f34f174aa", "d23787e8c8fa27be"),
    ("covcov_k2_p8_m16_d2_n80", 1963300411):
        ("0255d4a3cfde1be8", "7c4e4e846d117472", "3b669ae3c6e9ead1"),
}


@pytest.mark.parametrize("name,seed", list(BITS))
def test_functional_configs_keep_their_bits(name, seed):
    config = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                        .read_text())
    raw = datagen.from_config(config, seed)
    data = _digest(list(raw["y"]) + list(raw["t"])
                   + ([] if raw["X"] is None else [raw["X"]])
                   + [raw["truth"][f] for f in datagen.FIELDS]
                   + [raw["degree"], raw["internal"], raw["boundary"]])
    c = harness.curves_of(raw)
    d = conditionals.Design(c, "cpu")
    assert (data, _digest([c.S, c.y, c.mask, c.X, c.n_obs]),
            _digest([d.G.numpy(), d.u.numpy(), d.X.numpy(), d.R.numpy()])
            ) == BITS[name, seed]


# --- an hd cell added as files only -------------------------------------

HD_SMALL = dict(N=30, n_time=[30, 60])
HD_CHAINS = 16
# every fault an hd cell can have is seen at this size (``tf32`` changes
# nothing on the CPU)
HD_SEEN = sorted(f for f in set(faults.FAULTS) - {"tf32"}
                 if faults.ONLY.get(f, "hd") == "hd")


@pytest.fixture(scope="module")
def hd_root(tmp_path_factory):
    return with_hd(tmp_path_factory.mktemp("hd"))


def _run_hd(root, name):
    bench, cell, config = spec.load_cell(name, root)
    return harness.run(bench, dict(cell, chains=HD_CHAINS),
                       dict(config, **HD_SMALL), seed=2 ** 31 + 5,
                       seconds=0.5, trace=False, device="cpu",
                       t0=time.perf_counter(), root=root)[0]


@pytest.mark.parametrize("name", list(HD_CELLS))
def test_hd_cell_is_correct(hd_root, name):
    _, cell, config = spec.load_cell(name, hd_root)
    assert config["name"] == HD_CONFIG_NAME and config["P"] == 36
    line = _run_hd(hd_root, name)
    assert line["correct"] is True and line["failed"] == 0, line["check"]
    assert set(line["metrics"]) == {"chain_sweeps_per_s", "setup_s"}
    assert set(line["check"]) == set(cell["limits"])


@pytest.mark.parametrize("name,fault", [(n, f) for n in HD_CELLS
                                        for f in HD_SEEN])
def test_faults_make_the_hd_cell_incorrect(hd_root, name, fault,
                                           monkeypatch):
    _, cell, _ = spec.load_cell(name, hd_root)
    faults.FAULTS[fault](monkeypatch.setattr, cell["limits"]["loglik_gap"])
    line = _run_hd(hd_root, name)
    assert line["correct"] is False and line["failed"] >= 1, line["check"]

