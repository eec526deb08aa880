"""The plain reference against the port on the CPU at a small size: the
basis, the simulated data, the log-likelihood and each field's full
conditional; and the control, whose TF32 factors read far wider of the
float64 reference than float32 does."""

import numpy as np
import pytest
import torch

from portbench import datagen, harness
from portbench.entries.common import program_data
from portbench.reference import bspline, check, conditionals, model
from portbench.tests.conftest import HD_CONFIG
from bayesfmmm_torch import api, convert
from bayesfmmm_torch.config import Priors
from bayesfmmm_torch.ops import gibbs
from bayesfmmm_torch.ops.mean import build_cache
from bayesfmmm_torch.basis import bspline_basis
from bayesfmmm_torch.models.likelihood import log_likelihood
from bayesfmmm_torch.utils.simulate import simulate_functional

SIZES = [dict(N=12, K=3, P=8, M=4, D=0, n_time=(20, 30)),
         dict(N=10, K=2, P=8, M=16, D=2, n_time=(25, 25), with_eta=True,
              with_xi=True)]
# an hd configuration at a small size: surfaces on upstream's 6 x 6 basis
HD_SIZE = dict(HD_CONFIG, N=12, n_time=(80, 100))
# the functional simulator's defaults, which ``from_config`` takes from a
# configuration's file
DEFAULTS = dict(sigma2=0.01, nu_scale=3.0, phi_scale=0.5, with_eta=False,
                with_xi=False)


def test_basis_equals_the_ports():
    t = np.r_[0.0, np.sort(np.random.default_rng(3).uniform(0, 1, 40)), 1.0]
    internal, boundary = datagen.knots(8)
    assert np.allclose(bspline.design(t, 3, internal, boundary),
                       bspline_basis(t, 3, internal, boundary), atol=1e-14)


@pytest.mark.parametrize("size", SIZES)
def test_datagen_is_the_ports_simulator(size):
    raw = datagen.simulate(2 ** 31 + 11, **size)
    data, truth = simulate_functional(seed=2 ** 31 + 11, device="cpu",
                                      **size)
    y, mask = data.y.numpy(), data.mask.numpy()
    for n, yn in enumerate(raw["y"]):
        assert np.array_equal(np.float32(yn), y[n][mask[n] > 0])
    for f in truth:
        assert np.array_equal(raw["truth"][f], truth[f])


def _states(size, chains=5, seed=4, device="cpu"):
    raw = datagen.from_config(dict(DEFAULTS, **size), seed)
    data = program_data(api, raw, device)
    rng = np.random.default_rng(seed)
    states = {f: np.repeat(raw["truth"][f][None], chains, 0)
              for f in raw["truth"]}
    for f in ("nu", "Phi", "chi", "eta", "xi"):
        states[f] = (states[f] + 0.05 * rng.normal(size=states[f].shape)
                     ).astype(np.float32)
    states["sigma2"] = np.float32(0.01 * rng.uniform(0.8, 1.2, chains))
    return raw, data, states


@pytest.mark.parametrize("size", SIZES + [HD_SIZE])
def test_reference_loglik_equals_the_ports(size):
    raw, data, states = _states(size)
    port = log_likelihood(convert.state_from_numpy(states, device="cpu"),
                          data).double().numpy()
    ref = model.loglik(states, harness.curves_of(raw))
    assert np.max(np.abs(port - ref)) < 1e-3 * np.max(np.abs(ref)) * 1e-2


@pytest.mark.parametrize("size", SIZES + [HD_SIZE])
def test_control_reads_far_wider_than_float32(size):
    raw, data, states = _states(size, chains=8)
    curves = harness.curves_of(raw)
    ref = model.loglik(states, curves)
    f32 = log_likelihood(convert.state_from_numpy(states, device="cpu"),
                         data).double().numpy()
    lower = model.loglik_lower(states, curves, "cpu")
    assert np.max(np.abs(lower - ref)) > 10 * np.max(np.abs(f32 - ref))


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -9])
    assert model.round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10,
                                            1.0, -3.0 - 2 ** -9]


def test_judge_takes_the_worst_call_and_pools_the_draws():
    per_call = [{"loglik_gap": 0.01, "stuck_chains": 0,
                 "z2": {"Phi": (96.0, 96)}},
                {"loglik_gap": 0.3, "stuck_chains": 0,
                 "z2": {"Phi": (110.0, 96)}},
                {"loglik_gap": 0.02, "stuck_chains": 1, "z2": {}}]
    limits = {"loglik_gap": 0.1, "stuck_chains": 0, "Phi_z2": 0.1}
    ok, failed, table = check.judge(per_call, limits)
    assert not ok and failed == 2
    assert table["loglik_gap"] == {"value": 0.3, "limit": 0.1}
    assert table["Phi_z2"]["value"] == pytest.approx(206 / 192 - 1)
    ok, failed, _ = check.judge(per_call, dict(limits, Phi_z2=0.05))
    assert not ok and failed == 3
    ok, _, table = check.judge(per_call[:1], dict(limits, nu_z2=1.0))
    assert not ok and table["nu_z2"]["value"] == float("inf")
    assert check.judge(per_call[:1], limits)[0] is True
    assert check.judge([], {"loglik_gap": 0.1})[0] is False


@pytest.mark.parametrize("size", SIZES + [HD_SIZE])
def test_conditionals_agree_with_the_ports_updaters(size):
    """Where the port's updater has just drawn a field from its full
    conditional, the reference's z of that field is N(0, I): mean z^2
    near 1 over 200 chains.  Phi, xi and chi are drawn jointly in one
    step; nu and eta block by block, so 40 rounds reach their joint
    conditional."""
    raw, data, states = _states(size, chains=200)
    states["sigma2"] = np.full(200, 0.01, np.float32)
    state = convert.state_from_numpy(states, device="cpu")
    hp = Priors().validate()
    g = torch.Generator().manual_seed(3)
    design = conditionals.Design(harness.curves_of(raw), "cpu")

    def z2(st, field):
        leaves = {f: getattr(st, f).numpy() for f in conditionals.NEEDS}
        s, n = conditionals.z2_sums(leaves, design, (field,))[field]
        return s / n

    assert z2(state, "Phi") > 1.5                  # not drawn: far off
    drawn = {"Phi": gibbs.update_phi, "chi": gibbs.update_chi_joint}
    rounds = {"nu": gibbs.update_nu}
    if size["D"]:
        drawn["xi"] = gibbs.update_xi
        rounds["eta"] = gibbs.update_eta
    for field, update in drawn.items():
        st, _ = update(g, state, data, hp, build_cache(data, state))
        assert abs(z2(st, field) - 1) < 0.05, field
    for field, update in rounds.items():
        st = state
        for _ in range(40):
            st, _ = update(g, st, data, hp, build_cache(data, st))
        assert abs(z2(st, field) - 1) < 0.1, field


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys
    from portbench.tests.conftest import ROOT
    code = ("import sys; sys.path.insert(0, %r);"
            "import portbench.reference.model, portbench.reference.check,"
            "portbench.reference.bspline, portbench.reference.conditionals;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    top = eval(out)
    assert "bayesfmmm_torch" not in top
    assert not {"jax", "jaxlib", "flax", "bayesfmmm_tpu"} & set(top)


# the two configurations' own sizes, and the hd drop-in's (PERF.md), whose
# surfaces of up to 897 points at seed 4 (not a multiple of 4) would have
# kept a control left to cuBLAS's TF32 switch in float32
CARD_SIZES = [dict(N=100, K=3, P=8, M=4, D=0, n_time=(100, 100)),
              dict(N=80, K=2, P=8, M=16, D=2, n_time=(100, 100),
                   with_eta=True, with_xi=True), HD_CONFIG]


@pytest.mark.cuda
@pytest.mark.parametrize("size", CARD_SIZES)
def test_control_on_the_card_reads_far_wider_than_the_program(size, card):
    """On the card the control's factors are rounded to TF32 as on the CPU;
    the program's float32 log-likelihood (K2) stays far closer to the
    float64 reference."""
    raw, data, states = _states(size, chains=64, device=card)
    curves = harness.curves_of(raw)
    ref = model.loglik(states, curves)
    prog = log_likelihood(convert.state_from_numpy(states, device=card),
                          data).double().cpu().numpy()
    lower = model.loglik_lower(states, curves, card)
    assert np.max(np.abs(lower - ref)) > 10 * np.max(np.abs(prog - ref))
