"""The port's exact-state checkpoint (io/checkpoint.py), the warm-ensemble
protocol of ``api.fit_warm_start`` and the batched runs, on the CPU.

Everything here is deterministic: equal means equal bits."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tensors here are small: one thread each, so that several test workers do
# not oversubscribe the cores with a thread pool apiece
torch.set_num_threads(1)

import jax  # noqa: E402

from bayesfmmm_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from bayesfmmm_tpu.io import checkpoint as jcheckpoint  # noqa: E402
from bayesfmmm_tpu.models.state import init_state as jinit_state  # noqa: E402
from bayesfmmm_tpu.utils.simulate import (  # noqa: E402
    simulate_functional as jsimulate)
from bayesfmmm_torch import api, convert  # noqa: E402
from bayesfmmm_torch.config import ModelConfig, Priors  # noqa: E402
from bayesfmmm_torch.io import armaio  # noqa: E402
from bayesfmmm_torch.io.checkpoint import (load_checkpoint,  # noqa: E402
                                           save_checkpoint)
from bayesfmmm_torch.models.state import STATE_FIELDS, init_state  # noqa: E402
from bayesfmmm_torch.samplers import batched  # noqa: E402
from bayesfmmm_torch.utils.simulate import simulate_functional  # noqa: E402

TT = dict(n_temp_trans=60, N_t=2, beta_N_t=0.5)


@pytest.fixture(scope="module")
def small():
    data, _ = simulate_functional(seed=5, N=8, K=2, P=5, M=2, n_time=(8, 10),
                                  device="cpu")
    r1 = api.fit_nu_z(data=data, K=2, M=2, tot_mcmc_iters=100, seed=0)
    r2 = api.fit_theta(r1, tot_mcmc_iters=100, seed=1)
    return data, r1, r2


def _same_result(a, b):
    for k in a.traces:
        np.testing.assert_array_equal(a.traces[k], b.traces[k])
    np.testing.assert_array_equal(a.all_chain_loglik, b.all_chain_loglik)
    np.testing.assert_array_equal(a.tt_accept, b.tt_accept)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.ensemble_state, f),
                           getattr(b.ensemble_state, f)), f


def test_checkpoint_roundtrip_is_exact(tmp_path, small):
    data = small[0]
    cfg = ModelConfig(K=2, P=5, M=2)
    g = torch.Generator().manual_seed(3)
    st = init_state(g, cfg, data, chains=3)
    path = tmp_path / "ck"              # ".npz" is appended
    save_checkpoint(path, st, g, iteration=17, config=cfg)
    want = torch.rand(5, generator=g)
    assert os.path.isfile(str(path) + ".npz")
    st2, g2, it, cfg2 = load_checkpoint(path, "cpu")
    assert it == 17 and cfg2 == cfg
    for f in STATE_FIELDS:
        assert torch.equal(getattr(st, f), getattr(st2, f)), f
    assert g2 is not g and torch.equal(torch.rand(5, generator=g2), want)
    with np.load(str(path) + ".npz") as z:
        assert {f"state__{f}" for f in STATE_FIELDS} <= set(z.files)
        assert str(z["generator_device"]) == "cpu"


def test_fit_warm_start_ensemble_resume(tmp_path, small):
    """Port of tests/test_checkpoint_parallel.py:171-205: checkpoint_to
    saves the full chain ensemble and the generator; resume_from continues
    it deterministically, with the iteration bookkeeping chained."""
    data, r1, r2 = small
    ck = str(tmp_path / "ens.npz")
    ra = api.fit_warm_start(r1, r2, tot_mcmc_iters=120, n_chains=3,
                            progress=False, checkpoint_to=ck)
    assert ra.ensemble_state.Z.shape[0] == 3
    assert ra.all_chain_loglik.shape == (3, 120)

    rb = api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                            progress=False)
    rc = api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                            progress=False)
    assert rb.ensemble_state.Z.shape[0] == 3
    _same_result(rb, rc)
    # the resumed ensemble actually moved from the checkpointed state
    assert float((rb.ensemble_state.nu - ra.ensemble_state.nu).abs().max()) \
        > 1e-6

    # chained resume: iteration bookkeeping accumulates, randomness fresh
    ck2 = str(tmp_path / "ens2.npz")
    api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                       progress=False, checkpoint_to=ck2)
    assert load_checkpoint(ck2, "cpu")[2] == 220
    rd = api.fit_warm_start(resume_from=ck2, data=data, tot_mcmc_iters=100,
                            progress=False)
    assert not np.array_equal(rd.traces["nu"][:100], rb.traces["nu"][:100])
    # theta_result in place of data=; neither is an error
    re_ = api.fit_warm_start(theta_result=r2, resume_from=ck,
                             tot_mcmc_iters=100, progress=False)
    _same_result(rb, re_)
    with pytest.raises(ValueError, match="needs data="):
        api.fit_warm_start(resume_from=ck, tot_mcmc_iters=100)


@pytest.mark.parametrize("kernels", ["reference", "production"])
def test_split_run_equals_unbroken_run(tmp_path, small, kernels):
    """100 + 100 sweeps through a checkpoint give the bits of one 200-sweep
    run from the same seed, tempered excursions (at 60, 120, 180) included:
    the schedule counts from the start of the whole run."""
    data, r1, r2 = small
    ck = str(tmp_path / "half.npz")
    kw = dict(n_chains=2, kernels=kernels, progress=False, seed=7, **TT)
    whole = api.fit_warm_start(r1, r2, tot_mcmc_iters=200, **kw)
    a = api.fit_warm_start(r1, r2, tot_mcmc_iters=100, checkpoint_to=ck, **kw)
    b = api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                           kernels=kernels, progress=False, **TT)
    assert a.tt_accept.shape == (2, 1) and b.tt_accept.shape == (2, 2)
    np.testing.assert_array_equal(
        np.concatenate([a.all_chain_loglik, b.all_chain_loglik], 1),
        whole.all_chain_loglik)
    np.testing.assert_array_equal(
        np.concatenate([a.tt_accept, b.tt_accept], 1), whole.tt_accept)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(b.ensemble_state, f),
                           getattr(whole.ensemble_state, f)), f


def test_draws_do_not_depend_on_progress_chunks(small):
    """A run is a function of (seed, tot_mcmc_iters, thinning_num, flags),
    not of ``progress`` or ``progress_every``."""
    data, r1, r2 = small
    kw = dict(tot_mcmc_iters=120, n_chains=2, seed=4, thinning_num=2, **TT)
    lines = []
    from bayesfmmm_torch.utils.observability import ProgressStream
    a = api.fit_warm_start(r1, r2, progress=False, **kw)
    b = api.fit_warm_start(r1, r2, progress_every=25, progress=ProgressStream(
        every=1, printer=lines.append), **kw)
    c = api.fit_warm_start(r1, r2, progress=False, progress_every=1000, **kw)
    assert a.loglik.shape == (60,) and a.tt_accept.shape == (2, 1)
    _same_result(a, b)
    _same_result(a, c)
    assert len(lines) == 5 and lines[-1].startswith("Iteration: 120 ")


def test_resume_reads_the_configuration_from_the_file(tmp_path, small):
    """The JAX package derives covariate_cov from xi's shape on resume,
    which is true of every state; the port writes the configuration into
    the file and reads it back."""
    data, r1, r2 = small
    ck = str(tmp_path / "ens.npz")
    ra = api.fit_warm_start(r1, r2, tot_mcmc_iters=100, n_chains=2,
                            progress=False, checkpoint_to=ck)
    rb = api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                            progress=False)
    assert rb.config == ra.config
    assert rb.config.covariate_cov is False
    assert rb.config.covariate_mean is False
    assert load_checkpoint(ck, "cpu")[3] == ra.config


def test_jax_written_npz_loads(tmp_path):
    """A checkpoint the JAX package wrote as .npz loads into the port's
    state; its key is no generator state, so the loader needs a seed."""
    jdata, _ = jsimulate(seed=5, N=8, K=2, P=5, M=2, n_time=(8, 10))
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jstates = jax.vmap(lambda k: jinit_state(
        k, JModelConfig(K=2, P=5, M=2), jdata))(keys)
    ck = str(tmp_path / "jax.npz")
    jcheckpoint.save_checkpoint(ck, jstates, keys, iteration=40)
    with pytest.raises(ValueError, match="pass seed="):
        load_checkpoint(ck, "cpu")
    st, g, it, cfg = load_checkpoint(ck, "cpu", seed=11)
    assert it == 40 and cfg is None
    assert g.initial_seed() == 11
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jstates, f)))
    # and the ensemble continues through the port's API
    data = convert.data_from_jax(jdata, device="cpu")
    res = api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100,
                             progress=False, seed=11,
                             checkpoint_to=str(tmp_path / "next.npz"))
    assert res.ensemble_state.Z.shape[0] == 3
    assert res.config == ModelConfig(K=2, P=5, M=2)
    assert load_checkpoint(str(tmp_path / "next.npz"), "cpu")[2] == 140
    # what the port writes, the JAX loader's names cover
    with np.load(str(tmp_path / "next.npz")) as z:
        assert {f"state__{f}" for f in jcheckpoint._FIELDS} <= set(z.files)
        assert "iteration" in z.files


def test_failed_write_raises(tmp_path, small):
    """No ``except Exception`` around the write: a checkpoint that cannot
    be written is an error, not a silent loss."""
    data, r1, r2 = small
    cfg = ModelConfig(K=2, P=5, M=2)
    g = torch.Generator().manual_seed(0)
    st = init_state(g, cfg, data, chains=1)
    missing = tmp_path / "no_such_dir" / "ck.npz"
    with pytest.raises(OSError):
        save_checkpoint(missing, st, g)
    with pytest.raises(OSError):
        api.fit_warm_start(r1, r2, tot_mcmc_iters=100, progress=False,
                           checkpoint_to=str(missing))
    assert not missing.parent.exists()


def test_checkpoint_of_another_device_type_is_refused(tmp_path, small):
    data = small[0]
    cfg = ModelConfig(K=2, P=5, M=2)
    g = torch.Generator().manual_seed(0)
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, init_state(g, cfg, data, chains=2), g, config=cfg)
    with np.load(ck) as z:
        arrs = dict(z)
    arrs["generator_device"] = np.asarray("cuda")
    np.savez(ck, **arrs)
    with pytest.raises(ValueError, match="'cuda' generator.*'cpu'"):
        load_checkpoint(ck, "cpu")
    with pytest.raises(ValueError, match="'cuda' generator.*'cpu'"):
        api.fit_warm_start(resume_from=ck, data=data, tot_mcmc_iters=100)


# ---------------------------------------------------------------------------
# The batched runs (samplers/batched.py)
# ---------------------------------------------------------------------------

def _batched_start(data, seed=0):
    cfg = ModelConfig(K=2, P=5, M=2)
    g = torch.Generator().manual_seed(seed)
    return cfg, g, init_state(g, cfg, data, chains=1)


def test_batched_run_and_resume_equal_the_unbroken_run(tmp_path, small):
    data = small[0]
    hp, c = Priors(), torch.full((2,), 10.0)
    kw = dict(r_stored_iters=20, thinning_num=2, n_temp_trans=15, N_t=2,
              beta_N_t=0.5, collapsed_z=True, gauge=True)
    cfg, g, st = _batched_start(data)
    whole = str(tmp_path / "whole")
    fin_w, ll_w, nb = batched.run_batched(
        g, st, data, hp, c, directory=whole, tot_mcmc_iters=80, config=cfg,
        **kw)
    assert nb == 4 and ll_w.shape == (40,)
    cfg, g, st = _batched_start(data)
    split = str(tmp_path / "split")
    batched.run_batched(g, st, data, hp, c, directory=split,
                        tot_mcmc_iters=40, config=cfg, checkpoint_every=1,
                        **kw)
    fin_s, ll_s, nb = batched.resume_batched(split, data, hp, c,
                                             additional_iters=40, **kw)
    assert nb == 2
    np.testing.assert_array_equal(ll_s, ll_w[20:])
    for f in STATE_FIELDS:
        assert torch.equal(getattr(fin_s, f), getattr(fin_w, f)), f
    a, b = armaio.load_trace_dir(whole), armaio.load_trace_dir(split)
    assert a["Nu"].shape == (40, 2, 5) and sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["Sigma"][-1],
                                  fin_w.sigma2.double().numpy()[0])


def test_resume_batched_refuses_stale_directory(tmp_path, small):
    data = small[0]
    hp, c = Priors(), torch.full((2,), 10.0)
    cfg, g, st = _batched_start(data)
    d = str(tmp_path / "run")
    batched.run_batched(g, st, data, hp, c, directory=d, tot_mcmc_iters=40,
                        r_stored_iters=20, config=cfg, checkpoint_every=1)
    os.remove(os.path.join(d, "Nu1.txt"))
    with pytest.raises(ValueError, match="refusing to mix"):
        batched.resume_batched(d, data, hp, c, additional_iters=20,
                               r_stored_iters=20)
    with pytest.raises(ValueError, match="one chain"):
        batched.run_batched(g, init_state(g, cfg, data, chains=2), data, hp,
                            c, directory=d, tot_mcmc_iters=20,
                            r_stored_iters=20, config=cfg)


def test_fit_warm_start_batched_branch(tmp_path, small):
    """r_stored_iters + directory: the ring/batch path; the traces come back
    from the files."""
    data, r1, r2 = small
    d = str(tmp_path / "ring")
    res = api.fit_warm_start(r1, r2, tot_mcmc_iters=100, r_stored_iters=50,
                             directory=d, progress=False, seed=3)
    assert res.loglik.shape == (100,) and res.traces["nu"].shape == (100, 2, 5)
    assert set(res.traces) == {"nu", "chi", "pi", "alpha3", "A", "delta",
                               "sigma2", "tau", "gamma", "Phi", "Z"}
    assert sorted(os.listdir(d))[:2] == ["A0.txt", "A1.txt"]
    np.testing.assert_array_equal(
        res.traces["sigma2"][-1], res.final_state.sigma2.double().numpy()[0])
    with pytest.raises(ValueError, match="resume_batched"):
        api.fit_warm_start(resume_from="x.npz", data=data,
                           tot_mcmc_iters=100, r_stored_iters=50, directory=d)
