"""The port's box-truncated smoother on the generic route and through the
dispatcher, against the JAX package.

The truncated Normal's density and domain check, ``fast_erfinv`` and the
dispatch decisions are deterministic and compared exactly or to float32
rounding. Whole runs draw from different streams in the two packages (threefry
against torch's generator and Philox), so they are compared in distribution with
the thresholds of tests/test_fused_engines_cpu_stats.py
(``test_truncated_smoother_engine_matches_generic``: every stored draw inside
the box, posterior means within 0.15 sd, sds within 15 %).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from test_fused_engines_cpu_stats import _smoother_problem

torch.set_num_threads(2)

LO, HI = 0.0, 1.2


def truncated_mcmc(pkg, p0="ridged", n_chains=128, n_burn=300, n_iter=400, state_edit=None, lo=LO, hi=HI):
    """``test_truncated_smoother_engine_matches_generic``'s model (p = 12 RW1 prior
    with a 1e-3 ridge, box [0, 1.2] on b, Gamma(2, 1) scales) in either package."""
    dist = importlib.import_module(f"{pkg}.distributions")
    params = importlib.import_module(f"{pkg}.parameters")
    smp = importlib.import_module(f"{pkg}.samplers")
    Model = importlib.import_module(f"{pkg}.model").Model
    MCMC = importlib.import_module(f"{pkg}.mcmc").MCMC
    gmrf = importlib.import_module(f"{pkg}.linalg.gmrf")
    st = importlib.import_module(f"{pkg}.linalg.structured")
    jax_side = pkg == "openmcmc_tpu"
    s, y = _smoother_problem()
    p = len(s)
    mdl = Model([
        dist.Normal("y", mean="b", precision=params.ScaledMatrix("P_tau", "tau")),
        dist.Normal("b", mean="mu", precision=params.ScaledMatrix("P0", "lam"),
                    domain_response_lower=lo, domain_response_upper=hi),
        dist.Gamma("lam", shape="a_lam", rate="b_lam"),
        dist.Gamma("tau", shape="a_tau", rate="b_tau"),
    ])
    bands = np.asarray(gmrf.precision_irregular(jnp.asarray(s, jnp.float32) if jax_side else s).bands).copy()
    bands[0, 0] += np.float32(0.001)
    if p0 == "ridged":
        P0 = st.Banded(jnp.asarray(bands) if jax_side else torch.from_numpy(bands))
    else:  # the same values as a bandwidth-2 Banded: not tridiagonal
        wide = np.concatenate([bands, np.zeros((1, p), np.float32)])
        P0 = st.Banded(jnp.asarray(wide) if jax_side else torch.from_numpy(wide))
    ones = jnp.ones(p) if jax_side else torch.ones(p)
    state = {
        "y": y.reshape(p, 1), "b": np.clip(y, lo, hi).reshape(p, 1), "mu": np.zeros((p, 1)), "P0": P0,
        "P_tau": st.Diagonal(ones), "lam": 1.0, "tau": 1.0, "a_lam": 2.0, "b_lam": 1.0, "a_tau": 2.0, "b_tau": 1.0,
    }
    if state_edit is not None:
        state_edit(state)
    samplers = [smp.NormalNormal("b", mdl), smp.NormalGamma("lam", mdl), smp.NormalGamma("tau", mdl)]
    kw = {} if jax_side else {"device": "cpu"}
    return MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains, seed=6, **kw)


@pytest.fixture(scope="module")
def jax_generic():
    m = truncated_mcmc("openmcmc_tpu")
    m.model.response = None
    return m.run()


def check_parity(b, lam, tau, gen):
    """The thresholds of test_truncated_smoother_engine_matches_generic."""
    p = b.shape[-2] if b.ndim == 4 else b.shape[-1]
    b_f = np.asarray(b).reshape(-1, p)
    assert b_f.min() >= LO - 1e-6 and b_f.max() <= HI + 1e-6
    b_g = np.asarray(gen.store["b"]).reshape(-1, p)
    assert (b_g < 0.05).mean() > 0.01  # the box is active
    sd = b_g.std(0)
    assert np.all(np.abs(b_f.mean(0) - b_g.mean(0)) < 0.15 * sd), np.abs(b_f.mean(0) - b_g.mean(0)) / sd
    assert np.all(np.abs(b_f.std(0) / sd - 1.0) < 0.15)
    for f, g in ((lam, "lam"), (tau, "tau")):
        fv, gv = np.asarray(f).reshape(-1), np.asarray(gen.store[g]).reshape(-1)
        assert abs(fv.mean() - gv.mean()) < 0.15 * gv.std(), g
        assert abs(fv.std() / gv.std() - 1.0) < 0.15, g


def test_port_generic_matches_jax_generic(jax_generic):
    """(e) The port's generic driver (red-black truncated NormalNormal, 128 chains,
    300 burn-in, 400 stored) against the JAX generic run."""
    res = truncated_mcmc("openmcmc_tpu_torch").run()
    assert res.engine == "generic"
    check_parity(res.store["b"].numpy(), res.store["lam"].numpy(), res.store["tau"].numpy(), jax_generic)


def test_port_k4_plain_matches_jax_generic(jax_generic):
    """(e) The port's K4 plain version on its own Philox bits, through
    ``MCMC.run(engine="auto")`` (512 chains, 200 burn-in, 250 stored), against the
    JAX generic run."""
    res = truncated_mcmc("openmcmc_tpu_torch", n_chains=512, n_burn=200, n_iter=250).run(engine="auto")
    assert res.engine == "fused_gmrf_smoother_truncated"
    check_parity(res.store["b"].numpy(), res.store["lam"].numpy(), res.store["tau"].numpy(), jax_generic)


def test_truncated_density_and_domain_match_jax():
    """(d) Normal.log_p (-inf outside the box, the untruncated density inside) and
    out_of_domain against the JAX package on the same states, unbatched and
    chain-batched, summed and by observation; rtol 1e-5."""
    jmodel = truncated_mcmc("openmcmc_tpu", n_burn=1, n_iter=1)
    tmodel = truncated_mcmc("openmcmc_tpu_torch", n_burn=1, n_iter=1)
    rng = np.random.default_rng(3)
    p = 12
    draws = [rng.uniform(0.1, 1.1, (p, 2)), rng.uniform(0.1, 1.1, (p, 2)), rng.uniform(0.1, 1.1, (p, 2))]
    draws[1][4, 1] = -0.01  # below the box in one column
    draws[2][7, 0] = 1.25   # above it
    jd, td = jmodel.model["b"], tmodel.model["b"]
    base_j = {**jmodel.data, "lam": jnp.full((1, 1), 2.0)}
    base_t = {**tmodel.data, "lam": torch.full((1, 1), 2.0)}
    for by_obs in (False, True):
        got_batch = td.log_p({**base_t, "b": torch.from_numpy(np.stack(draws).astype(np.float32))},
                             by_observation=by_obs).numpy()
        for k, b in enumerate(draws):
            want = np.asarray(jd.log_p({**base_j, "b": jnp.asarray(b, jnp.float32)}, by_observation=by_obs))
            got = td.log_p({**base_t, "b": torch.from_numpy(b.astype(np.float32))}, by_observation=by_obs).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-5)
            np.testing.assert_allclose(got_batch[k], want, rtol=1e-5)
            assert bool(td.out_of_domain({"b": torch.from_numpy(b)})) == bool(jd.out_of_domain({"b": jnp.asarray(b)}))
    assert np.isfinite(got_batch[0]).all() and np.isneginf(got_batch[1:]).all()
    flags = td.out_of_domain({"b": torch.from_numpy(np.stack(draws))})
    assert flags.tolist() == [False, True, True]


def test_dispatch_decisions_match_jax():
    """(f) match_fused_engine in both packages on the same models: a truncated
    tridiagonal prior -> fused_gmrf_smoother_truncated; a truncated bandwidth-2
    prior and a two-column initial latent -> no engine (the generic route); an
    untruncated tridiagonal prior with p = 1100 -> fused_gmrf_smoother, whose run
    (4 chains, 1 burn-in and 2 stored sweeps) the port makes on the CPU."""
    from openmcmc_tpu.fused.dispatch import match_fused_engine as jmatch
    from openmcmc_tpu_torch.fused.dispatch import match_fused_engine as tmatch

    def two_columns(state):
        state["b"] = np.repeat(state["b"], 2, axis=1)

    cases = {
        "truncated": dict(),
        "truncated_bw2": dict(p0="wide"),
        "per_chain_init": dict(state_edit=two_columns),
    }
    want_names = {"truncated": "fused_gmrf_smoother_truncated", "truncated_bw2": None, "per_chain_init": None}
    for name, kw in cases.items():
        j = jmatch(truncated_mcmc("openmcmc_tpu", n_burn=1, n_iter=2, **kw))
        t = tmatch(truncated_mcmc("openmcmc_tpu_torch", n_burn=1, n_iter=2, **kw))
        assert getattr(j, "engine_name", None) == getattr(t, "engine_name", None) == want_names[name], name
        if t is not None:
            assert t.store_keys == j.store_keys == frozenset({"b", "lam", "tau"})

    from test_torch_mcmc import build
    from openmcmc_tpu.linalg import gmrf as jgmrf
    from openmcmc_tpu.linalg import structured as jst
    from openmcmc_tpu_torch.convert import state_from_reference

    p = 1100
    s = np.linspace(0.0, 0.6 * (p - 1), p)
    P = jgmrf.precision_irregular(jnp.asarray(s, jnp.float32))
    y = np.sin(s / 20.0) + np.random.default_rng(0).normal(0.0, 1.0, p)
    state = {"y": y, "b": y.copy(), "mu": np.zeros(p), "lambda": 100.0, "P_lambda": jst.Banded(P.bands.at[0, 0].add(1e-3)),
             "a_lam": 10.0, "b_lam": 1.0, "tau": 1.0, "P_tau": jst.Diagonal(jnp.ones(p)), "a_tau": 1.0, "b_tau": 1.0}
    j = build("openmcmc_tpu", state, 1, None, None)
    t = build("openmcmc_tpu_torch", state_from_reference(state, device="cpu"), 1, None, None, device="cpu")
    assert jmatch(j).engine_name == tmatch(t).engine_name == "fused_gmrf_smoother"
    t.n_chains, t.n_burn, t.n_iter = 4, 1, 2
    res = t.run(engine="auto")
    assert res.engine == "fused_gmrf_smoother"
    assert tuple(res.store["b"].shape) == (4, 2, p, 1) and tuple(res.log_post.shape) == (4, 2)
    assert all(bool(torch.all(torch.isfinite(v))) for v in (*res.store.values(), res.log_post))


def test_fast_erfinv_matches_jax():
    """linalg/random.fast_erfinv against the JAX package's on the same float32
    inputs, both branches and the clamp; rtol 2e-6 (float32 rounding of log)."""
    from openmcmc_tpu.linalg.random import fast_erfinv as jerfinv
    from openmcmc_tpu_torch.linalg.random import fast_erfinv

    x = np.concatenate([np.linspace(-0.9999999, 0.9999999, 4001), [0.0, 1.0, -1.0, 0.99999994]]).astype(np.float32)
    np.testing.assert_allclose(fast_erfinv(torch.from_numpy(x)).numpy(), np.asarray(jerfinv(jnp.asarray(x))),
                               rtol=2e-6, atol=1e-7)


def test_truncated_normal_rv_and_prior_draw():
    """truncated_normal_rv draws scipy's truncated normal (KS p > 1e-3 on a
    two-sided and a one-sided box, every draw inside); a truncated prior left
    out of the state is drawn by sample_truncated_normal inside its box, and the
    generic run goes on from it."""
    from openmcmc_tpu_torch.linalg import gmrf

    key = gmrf.Key(torch.Generator().manual_seed(0))
    n = 20000
    for lo, hi, mean, scale in ((-0.5, 1.0, 0.3, 0.8), (1.0, None, 0.0, 1.0)):
        x = gmrf.truncated_normal_rv(key, torch.full((n,), mean), scale, lo, hi).numpy()
        a, b = (lo - mean) / scale, (np.inf if hi is None else (hi - mean) / scale)
        assert x.min() >= lo and (hi is None or x.max() <= hi)
        assert stats.kstest(x, stats.truncnorm(a, b, loc=mean, scale=scale).cdf).pvalue > 1e-3

    mcmc = truncated_mcmc("openmcmc_tpu_torch", n_chains=64, n_burn=2, n_iter=3, state_edit=lambda s: s.pop("b"))
    init = mcmc._init_chain_state(torch.Generator().manual_seed(1))["b"]
    assert init.shape == (64, 12, 1) and float(init.min()) >= LO and float(init.max()) <= HI
    res = mcmc.run()
    b = res.store["b"]
    assert float(b.min()) >= LO and float(b.max()) <= HI and bool(torch.all(torch.isfinite(res.log_post)))
