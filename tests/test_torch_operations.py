"""The port's operations against the JAX package's: resume, ``final_key``,
checkpoints, ``run_chunked``, the cached match, ``run_mcmc`` and
``last_engine`` (mirroring tests/test_checkpoint.py and
tests/test_resume_streams.py).

The K1 and K11 resumes run in both packages on the same bits: the JAX engine
in interpret mode with a host bit source, the port's plain version fed those
bits (``jax_kernel_bits``, ``rj_bits``), each starting from the same warm
state and holding its draws to float32 rounding. The K11 warm state is made by
hand (per-chain counts, knots, widths, coefficients, tau and counters) rather
than by a JAX run, whose interpret-mode trace would double the test's time.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmcmc_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from openmcmc_tpu.mcmc import MCMCResult as JaxResult
from openmcmc_tpu_torch import checkpoint
from openmcmc_tpu_torch.fused import dispatch
from openmcmc_tpu_torch.mcmc import MCMCResult, next_key
from test_torch_mcmc import build as flagship, reference_state
from test_torch_rj import rj_bits, rj_mcmc
from test_torch_spectral import host_stats, jax_kernel_bits  # noqa: F401  (host_stats is a fixture)

torch.set_num_threads(2)

JAX, PORT = "openmcmc_tpu", "openmcmc_tpu_torch"
P = 16


def _mods(pkg):
    names = ("distributions", "parameters", "samplers", "model", "mcmc", "linalg.structured", "linalg.gmrf")
    return [importlib.import_module(f"{pkg}.{m}") for m in names]


def _vec(pkg, x):
    return jnp.asarray(x, jnp.float32) if pkg == JAX else torch.as_tensor(np.asarray(x, np.float32))


def _kw(pkg):
    return {"device": "cpu"} if pkg == PORT else {}


def smoother(pkg, truncated=False, n_chains=8):
    """tests/test_resume_streams.py's smoother: p = 16 RW1 prior with a 1e-3
    ridge, optionally box-truncated to [0, 2]; 3 + 4 sweeps."""
    dist, par, smp, model, mcmc, st, _ = _mods(pkg)
    from openmcmc_tpu.linalg import gmrf as jgmrf

    s = np.linspace(0.0, 10.0, P)
    bands = np.array(jgmrf.precision_irregular(jnp.asarray(s)).bands)
    bands[0, 0] += 0.001
    y = np.abs(np.sin(s)) + np.random.default_rng(0).normal(0.0, 0.3, P)
    trunc = dict(domain_response_lower=0.0, domain_response_upper=2.0) if truncated else {}
    mdl = model.Model([
        dist.Normal("y", mean="b", precision=par.ScaledMatrix("P_tau", "tau")),
        dist.Normal("b", mean="mu", precision=par.ScaledMatrix("P_lambda", "lambda"), **trunc),
        dist.Gamma("lambda", shape="a_lam", rate="b_lam"),
        dist.Gamma("tau", shape="a_tau", rate="b_tau"),
    ])
    state = {"y": y, "b": np.clip(y, 1e-3, 2.0 - 1e-3) if truncated else y.copy(), "mu": np.zeros(P),
             "lambda": 10.0, "P_lambda": st.Banded(_vec(pkg, bands)), "a_lam": 10.0, "b_lam": 1.0, "tau": 1.0,
             "P_tau": st.Diagonal(_vec(pkg, np.ones(P))), "a_tau": 1.0, "b_tau": 1.0}
    samplers = [smp.NormalNormal("b", mdl), smp.NormalGamma("lambda", mdl), smp.NormalGamma("tau", mdl)]
    return mcmc.MCMC(state, samplers, mdl, n_burn=3, n_iter=4, n_chains=n_chains, seed=0, **_kw(pkg))


def linreg(pkg, p=2):
    """Example 3 (p = 2), or a p-column design past K6's limit (K5)."""
    dist, par, smp, model, mcmc, st, _ = _mods(pkg)
    rng = np.random.default_rng(1)
    X = np.concatenate([np.ones((40, 1)), rng.normal(size=(40, p - 1))], 1)
    y = X @ np.linspace(2.0, 0.5, p) + rng.normal(0, 1.0, 40)
    mdl = model.Model([
        dist.Normal("y", mean=par.LinearCombination(form={"beta": "X"}), precision=par.ScaledMatrix("P_tau", "tau")),
        dist.Normal("beta", mean="mu", precision=par.ScaledMatrix("P_lambda", "lambda")),
        dist.Gamma("tau", shape="a_tau", rate="b_tau"),
        dist.Gamma("lambda", shape="a_lambda", rate="b_lambda"),
    ])
    state = {"y": y, "X": X, "beta": np.zeros(p), "P_tau": st.Diagonal(_vec(pkg, np.ones(40))), "tau": 1.0,
             "P_lambda": st.Diagonal(_vec(pkg, np.ones(p))), "mu": np.zeros(p), "lambda": 0.01,
             "a_tau": 1e-3, "b_tau": 1e-3, "a_lambda": 1e-3, "b_lambda": 1e-3}
    samplers = [smp.NormalNormal("beta", mdl), smp.NormalGamma("tau", mdl), smp.NormalGamma("lambda", mdl)]
    return mcmc.MCMC(state, samplers, mdl, n_burn=3, n_iter=4, n_chains=8, seed=0, **_kw(pkg))


def rw(pkg, n_iter=4):
    """The reference's example 2: RandomWalk on h."""
    dist, _, smp, model, mcmc, _, _ = _mods(pkg)
    mdl = model.Model([dist.Normal("y", mean="h", precision="tau"), dist.Normal("h", mean="mu", precision="lambda")])
    state = {"y": np.array([[150.0, 155.0, 190.0, 160.0, 173.0]]), "h": 200.0, "tau": np.eye(1) / 200.0,
             "mu": 160.0, "lambda": np.eye(1) / 100.0}
    return mcmc.MCMC(state, [smp.RandomWalk("h", mdl, step=5.0)], mdl, n_burn=3, n_iter=n_iter, n_chains=8, seed=0,
                     **_kw(pkg))


def mmala(pkg):
    dist, par, smp, model, mcmc, st, _ = _mods(pkg)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(12, 3))
    y = X @ rng.normal(size=3)
    mdl = model.Model([
        dist.Normal("y", mean=par.LinearCombination(form={"beta": "X"}), precision=par.ScaledMatrix("P", "tau")),
        dist.Normal("beta", mean="mu0", precision=par.ScaledMatrix("P0", "one")),
    ])
    state = {"y": y.reshape(-1, 1), "X": X, "beta": np.zeros((3, 1)), "P": st.Diagonal(_vec(pkg, np.ones(12))),
             "tau": 1.0, "P0": st.Diagonal(_vec(pkg, np.ones(3))), "mu0": np.zeros((3, 1)), "one": 1.0}
    return mcmc.MCMC(state, [smp.ManifoldMALA("beta", mdl, step=1.0)], mdl, n_burn=2, n_iter=3, n_chains=4, seed=0,
                     **_kw(pkg))


def mixture(pkg):
    dist, par, smp, model, mcmc, st, _ = _mods(pkg)
    rng = np.random.default_rng(3)
    n = 40
    y = np.where(rng.random(n) > 0.5, 2.0, -2.0) + 0.5 * rng.normal(size=n)
    mdl = model.Model([
        dist.Normal("y", mean=par.MixtureParameterVector("mu", "Z"), precision=par.MixtureParameterMatrix("lam", "Z")),
        dist.Categorical("Z", prob="w"),
        dist.Normal("mu", mean="mu0", precision="p0"),
        dist.Gamma("lam", shape="a0", rate="b0"),
    ])
    state = {"y": y.reshape(n, 1), "w": np.full((n, 2), 0.5), "Z": np.zeros((n, 1), np.int32),
             "mu": np.array([[-1.0], [1.0]]), "lam": np.ones((2, 1)), "mu0": np.zeros((2, 1)),
             "p0": st.Diagonal(_vec(pkg, np.full(2, 0.1))), "a0": np.full((2, 1), 2.0), "b0": np.ones((2, 1))}
    samplers = [smp.MixtureAllocation("Z", mdl, response_param="y"), smp.NormalNormal("mu", mdl),
                smp.NormalGamma("lam", mdl)]
    return mcmc.MCMC(state, samplers, mdl, n_burn=3, n_iter=4, n_chains=8, seed=0, store_names=["Z", "mu", "lam"],
                     **_kw(pkg))


def rj(pkg=PORT):
    return rj_mcmc(pkg, n_max=4, n_chains=8, n_burn=2, n_iter=3, store=("n_basis", "beta", "theta", "omega"),
                   n_data=8)


def _jax_seed(final_key) -> int:
    """The kernel seed the JAX package's fused resume derives from a result's keys."""
    return int(np.asarray(jax.random.key_data(jnp.asarray(final_key)[0])).reshape(-1)[-1] & 0x7FFFFFFF)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------------------
# resume on the same bits as the JAX package
# ---------------------------------------------------------------------------


def test_k1_resume_matches_jax(host_stats):  # noqa: F811
    """The flagship at p = 16 (8 chains, 3 burn-in, 5 stored sweeps): the JAX
    fused run, then each package's fused resume from its final_state on the JAX
    resume's bits: draws, scales and log_post within rtol 1e-4, atol 1e-5."""
    from openmcmc_tpu_torch.convert import state_from_reference

    state = reference_state()
    mj = flagship(JAX, state, 1, None, None)
    first = mj.run(engine="auto")
    want = mj.run(engine="auto", resume=first)
    assert want.engine == "fused_smoother_spectral"
    mt = flagship(PORT, state_from_reference(state, device="cpu"), 1, None, None, device="cpu")
    resume = MCMCResult(store={}, log_post=torch.zeros(()), stats=_to_torch(first.stats),
                        final_state=_to_torch(first.final_state), final_key=12345)
    got = mt.run(engine="auto", resume=resume, bit_source=jax_kernel_bits(_jax_seed(first.final_key), P))
    assert got.engine == want.engine and mt.last_engine == "fused_smoother_spectral"
    for name in ("b", "lambda", "tau"):
        np.testing.assert_allclose(got.store[name].numpy(), np.asarray(want.store[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    lp_t, lp_j = got.log_post.numpy(), np.asarray(want.log_post)
    assert np.all(np.abs(lp_t - lp_j) <= 1e-4 * np.maximum(1.0, np.abs(lp_j)))
    assert got.final_key == next_key(12345)


def test_k11_resume_matches_jax(host_stats):  # noqa: F811
    """Reversible jump with data (n_max 3, 8 points, 8 chains, 2 stored
    sweeps, parameters streamed) resumed in both packages from one warm state
    with per-chain counts: every count and counter equal, the draws, tau and
    log_post within rtol 1e-4, atol 1e-5."""
    nc, n_max = 8, 3
    rng = np.random.default_rng(4)
    k = rng.integers(1, n_max + 1, nc)
    act = np.arange(n_max)[None, :] < k[:, None]
    fs = {"beta": (rng.normal(size=(nc, n_max)) * act)[..., None].astype(np.float32),
          "theta": (rng.uniform(-8, 8, (nc, n_max)) * act)[:, None, :].astype(np.float32),
          "omega": (rng.uniform(1.0, 2.0, (nc, n_max)) * act)[:, None, :].astype(np.float32),
          "n_basis": k.reshape(nc, 1, 1).astype(np.int32), "tau_y": rng.uniform(1.0, 5.0, (nc, 1, 1)).astype(np.float32)}
    stats = {name: {"accept": np.full(nc, a, np.int32), "proposal": np.full(nc, 9, np.int32)}
             for name, a in (("beta", 5), ("theta", 7), ("omega", 6), ("n_basis", 3))}
    stats["tau_y"] = {}
    keys = jax.random.split(jax.random.PRNGKey(3), nc)
    store = ("n_basis", "beta", "theta", "omega", "tau_y")
    mj = rj_mcmc(JAX, n_max=n_max, n_chains=nc, n_iter=2, lik=True, store=store, n_data=8)
    want = mj.run(engine="auto", resume=JaxResult(store={}, log_post=jnp.zeros(()), stats=stats, final_state=fs,
                                                 final_key=keys))
    mt = rj_mcmc(PORT, n_max=n_max, n_chains=nc, n_iter=2, lik=True, store=store, n_data=8)
    got = mt.run(engine="auto", resume=MCMCResult(store={}, log_post=torch.zeros(()), stats=_to_torch(stats),
                                                  final_state=_to_torch(fs), final_key=5),
                 bit_source=rj_bits(_jax_seed(keys), nc))
    assert got.engine == want.engine == "fused_rj"
    np.testing.assert_array_equal(got.store["n_basis"].numpy(), np.asarray(want.store["n_basis"]))
    for name in ("beta", "theta", "omega", "n_basis"):
        for key in ("accept", "proposal"):
            np.testing.assert_array_equal(got.stats[name][key].numpy(), np.asarray(want.stats[name][key]),
                                          err_msg=f"{name} {key}")
    for name in ("beta", "theta", "omega", "tau_y"):
        np.testing.assert_allclose(got.store[name].numpy(), np.asarray(want.store[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(got.log_post.numpy(), np.asarray(want.log_post), rtol=1e-4, atol=1e-5)
    assert np.all(got.stats["n_basis"]["proposal"].numpy() == 9 + 2)


# ---------------------------------------------------------------------------
# the resume-stream matrix
# ---------------------------------------------------------------------------

RESUMABLE = [
    ("generic_smoother", smoother, "generic", "generic"),
    ("fused_spectral_smoother", smoother, "auto", "fused_smoother_spectral"),
    ("fused_truncated_smoother", lambda pkg: smoother(pkg, truncated=True), "auto", "fused_gmrf_smoother_truncated"),
    ("fused_linreg", linreg, "auto", "fused_linreg"),
    ("fused_linreg_spectral", lambda pkg: linreg(pkg, p=20), "auto", "fused_linreg_spectral"),
    ("fused_rj", rj, "auto", "fused_rj"),
]


@pytest.mark.parametrize("name,make,engine,expect", RESUMABLE, ids=[c[0] for c in RESUMABLE])
def test_resume_streams_advance(name, make, engine, expect):
    """final_key differs from the fresh run's seed and advances again on a
    resume, which runs the same engine with no burn-in, n_iter more draws and
    the counters accumulated."""
    m = make(PORT)
    first = m.run(engine=engine)
    assert first.engine == expect
    assert first.final_key not in (m.seed, m.seed & 0x7FFFFFFF)
    second = m.run(resume=first, engine=engine)
    assert second.engine == expect
    assert second.final_key not in (first.final_key, m.seed)
    third = m.run(resume=second, engine=engine)
    assert len({m.seed, first.final_key, second.final_key, third.final_key}) == 4
    assert second.log_post.shape == first.log_post.shape
    assert all(bool(torch.all(torch.isfinite(v))) for v in second.store.values() if v.dtype.is_floating_point)
    for sampler, stats in first.stats.items():
        # the random walks over theta and omega propose once per active column
        if "proposal" in stats and sampler not in ("theta", "omega"):
            torch.testing.assert_close(second.stats[sampler]["proposal"], stats["proposal"] + m.n_iter * m.n_thin)
        if "accept" in stats:
            assert bool(torch.all(second.stats[sampler]["accept"] >= stats["accept"])), sampler


def test_next_key_spreads_seeds_and_does_not_cycle():
    """A small seed's next key is not a small seed (so a resume of a seed-0 run
    does not replay a fresh run of a popular seed), and the keys of 10,000
    successive resumes are all distinct."""
    small = range(1000)
    assert all(next_key(s) >= 1 << 20 for s in small)
    keys = [12345]
    for _ in range(10_000):
        keys.append(next_key(keys[-1]))
    assert len(set(keys)) == len(keys)
    assert next_key(0x7FFFFFFF) != 0x7FFFFFFF and next_key(-1) == next_key(0x7FFFFFFF)


STAGED = [("rw", rw, "fused_random_walk"), ("mmala", mmala, "fused_mmala"),
          ("mixture_conjugate", mixture, "fused_mixture_conjugate")]


@pytest.mark.parametrize("name,make,engine", STAGED, ids=[c[0] for c in STAGED])
def test_unresumable_engines_fall_back(name, make, engine):
    """K7, K8 and K10 take shared initial values only: under "auto" their
    resume runs the generic driver on the advanced key, and "fused" raises."""
    m = make(PORT)
    first = m.run(engine="auto")
    assert first.engine == engine and m.last_engine == engine
    assert dispatch.match_fused_engine(m, resume=first) is None
    second = m.run(engine="auto", resume=first)
    assert second.engine == "generic" and second.final_key not in (first.final_key, m.seed)
    with pytest.raises(ValueError, match="supports resume"):
        m.run(engine="fused", resume=first)


def test_count_only_rj_result_resumes_generically():
    """A fused reversible-jump result that stored only the count has no padded
    parameters to warm-start from: the fused gate refuses it, and the generic
    driver, which continues every sampled entry, says which are missing."""
    m = rj_mcmc(PORT, n_max=4, n_chains=8, n_burn=1, n_iter=2, store=("n_basis",), n_data=8)
    first = m.run(engine="auto")
    assert first.engine == "fused_rj" and sorted(first.final_state) == ["n_basis"]
    assert dispatch.match_fused_engine(m, resume=first) is None
    with pytest.raises(ValueError, match="final_state has no"):
        m.run(engine="auto", resume=first)
    with pytest.raises(ValueError, match="does not lead with the 16 chains"):
        rj_mcmc(PORT, n_max=4, n_chains=16, n_data=8).run(resume=first)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["generic", "auto"])
def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path, engine):
    m = smoother(PORT)
    res = m.run(engine=engine)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(path, res)
    restored = checkpoint.load_checkpoint(path, device="cpu")
    assert restored.final_key == res.final_key and restored.store == {}
    for name in res.final_state:
        assert torch.equal(restored.final_state[name], res.final_state[name]), name
    assert restored.stats == {"b": {}, "lambda": {}, "tau": {}}
    live, again = m.run(resume=res, engine=engine), m.run(resume=restored, engine=engine)
    assert live.engine == again.engine == res.engine
    for name in live.store:
        assert torch.equal(live.store[name], again.store[name]), name
    assert torch.equal(live.log_post, again.log_post) and live.final_key == again.final_key


def test_checkpoint_layout_matches_jax(tmp_path):
    """The flattened key set of one model's checkpoint, with the store, equals
    the JAX package's; only final_key's shape differs (one seed here, (n_chains,
    2) keys there). A Metropolis sampler's statistics round-trip with their
    dtypes; a path that is not .npz raises."""
    jres = rw(JAX, n_iter=2).run()
    jax_save_checkpoint(str(tmp_path / "jax.npz"), jres, include_store=True)
    m = rw(PORT, n_iter=2)
    res = m.run()
    checkpoint.save_checkpoint(str(tmp_path / "port.npz"), res, include_store=True)
    with np.load(tmp_path / "jax.npz") as jf, np.load(tmp_path / "port.npz") as tf:
        assert sorted(jf.files) == sorted(tf.files)
        assert "stats/h/logp" in tf.files
        for name in tf.files:
            assert tf[name].shape == (() if name == "final_key" else jf[name].shape), name
        assert jf["final_key"].shape == (m.n_chains, 2)
    restored = checkpoint.load_checkpoint(str(tmp_path / "port.npz"), device="cpu")
    for key, value in res.stats["h"].items():
        assert torch.equal(restored.stats["h"][key], value) and restored.stats["h"][key].dtype == value.dtype
    assert torch.equal(restored.store["h"], res.store["h"]) and torch.equal(restored.log_post, res.log_post)
    with pytest.raises(ValueError, match=".npz"):
        checkpoint.save_checkpoint(str(tmp_path / "ckpt_dir"), res)


# ---------------------------------------------------------------------------
# run_chunked, the cached match, run_mcmc
# ---------------------------------------------------------------------------


def test_run_chunked(tmp_path, capsys):
    """Four chunks of 10 of the smoother: the store and log_post of one 40-draw
    run, the progress line, a checkpoint of the last chunk, the posterior mean
    of b within MC error of an unchunked run of another seed."""
    m = smoother(PORT, n_chains=16)
    m.n_iter = 40
    res = m.run_chunked(4, checkpoint_path=str(tmp_path / "chunk.npz"), progress=True)
    assert tuple(res.store["b"].shape) == (16, 40, P, 1) and tuple(res.log_post.shape) == (16, 40)
    assert m.n_iter == 40 and bool(torch.all(torch.isfinite(res.log_post)))
    assert "40/40 iterations" in capsys.readouterr().out
    assert checkpoint.load_checkpoint(str(tmp_path / "chunk.npz"), device="cpu").final_key == res.final_key
    other = smoother(PORT, n_chains=16)
    other.n_iter, other.seed = 40, 1
    full = other.run()
    np.testing.assert_allclose(res.store["b"].double().mean((0, 1)).numpy(),
                               full.store["b"].double().mean((0, 1)).numpy(), atol=0.2)


def test_run_chunked_offload(tmp_path):
    """offload=True: the same draws as on-device chunks, as CPU tensors, and one
    .npz shard per chunk holding its draws."""
    m = smoother(PORT)
    m.n_iter = 40
    on_device = m.run_chunked(4, progress=False, engine="auto")
    off = m.run_chunked(4, checkpoint_path=str(tmp_path / "off.npz"), progress=False, engine="auto", offload=True)
    assert off.engine == "fused_smoother_spectral"
    assert off.store["b"].device.type == "cpu" and off.log_post.device.type == "cpu"
    assert torch.equal(off.store["b"], on_device.store["b"]) and torch.equal(off.log_post, on_device.log_post)
    shards = sorted(tmp_path.glob("off.npz.chunk*.npz"))
    assert len(shards) == 4
    with np.load(shards[0]) as first:
        np.testing.assert_array_equal(first["b"], off.store["b"][:, :10].numpy())
        assert first["log_post"].shape == (8, 10)


def test_cached_match(monkeypatch):
    """A second run() of one object does not re-match; a changed n_iter, a
    rebound data entry and a resume do."""
    calls = []
    real = dispatch.match_fused_engine

    def counting(mcmc, resume=None):
        calls.append(resume is not None)
        return real(mcmc, resume=resume)

    monkeypatch.setattr(dispatch, "match_fused_engine", counting)
    m = smoother(PORT)
    first = m.run(engine="auto")
    again = m.run(engine="auto")
    assert calls == [False] and torch.equal(first.store["b"], again.store["b"])
    m.n_iter = 5
    assert tuple(m.run(engine="auto").store["b"].shape) == (8, 5, P, 1) and calls == [False, False]
    m.data["y"] = m.data["y"] + 1.0
    m.run(engine="auto")
    m.run(engine="auto", resume=first)
    assert calls == [False, False, False, True]


def test_run_mcmc_progress_and_last_engine(capsys):
    m = rw(PORT)
    assert m.last_engine is None
    res = m.run_mcmc()
    assert res.engine == "generic" and m.last_engine is None
    out = capsys.readouterr().out
    rate = float(res.acceptance["h"].double().mean())
    assert f"h: Acceptance rate {rate:.0f}%" in out
    seen = []
    m.run(progress_every=2, progress_callback=lambda done, total: seen.append((done, total)))
    assert seen == [(2, 4), (4, 4)]
    m.run(progress_every=4)
    assert "[openmcmc_tpu_torch] 4/4 iterations" in capsys.readouterr().out
    m.run(engine="auto")
    assert m.last_engine == "fused_random_walk"
