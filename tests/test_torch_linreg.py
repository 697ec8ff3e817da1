"""The port's linear regression against the JAX package's: the unrolled-Cholesky
engine (kernel K6's plain version, ``fused/linreg.py``), the spectral engine
(kernel K5's plain version, ``fused/spectral.py``), the host preparation, the
generic driver's dense NormalNormal step on a LinearCombination mean, and the
dispatch.

The JAX engines run their Pallas kernels in interpret mode with a host bit
source (see tests/test_torch_spectral.py); the port's plain versions take the
same bits, the first p rows and chains of grid program 0, and must reproduce
the JAX draws within rtol 1e-4, atol 1e-5 (log_post 1e-4 relative).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmcmc_tpu.fused import linreg as jlinreg
from openmcmc_tpu.fused import spectral as jspectral
from openmcmc_tpu_torch.fused import linreg as tlinreg
from openmcmc_tpu_torch.fused import spectral as tspectral
from openmcmc_tpu_torch.utils import profiling
from test_torch_spectral import host_stats  # noqa: F401  (a fixture)

torch.set_num_threads(2)


def kernel_bits(seed, site0_rows, block):
    """The bits an interpret-mode JAX kernel draws in grid program 0 under a
    host bit source, as a port bit source ``(sweep, site, (chains, width))``:
    site 0 is (site0_rows, block), every other site (width, block). One jitted
    draw per shape (tests/test_torch_spectral.py's source, compiled)."""
    base = jax.random.PRNGKey(seed)
    draw = jax.jit(lambda it, site, rows: jax.random.bits(jax.random.fold_in(jax.random.fold_in(base, it), site),
                                                          (rows, block), jnp.uint32), static_argnums=2)

    def source(it, site, shape):
        chains, width = shape
        bits = np.asarray(draw(it, site, site0_rows if site == 0 else width))
        return torch.from_numpy(bits[:width, :chains].T.astype(np.int64))

    return source


def k6_bits(seed, p):
    """K6's: site 0 is (p, BLOCK_B), every Gamma site (1, BLOCK_B)."""
    return kernel_bits(seed, p, jlinreg.BLOCK_B)


def k5_bits(seed, p):
    """K5's: site 0 spans p rounded up to PAD rows, the Gamma pair's sites 2."""
    p_pad = p + (-p) % jspectral.PAD
    return kernel_bits(seed, p_pad, jspectral._block_b(p_pad))


def regression(N, p, noise, seed, intercept=False):
    """X (N, p), y = X beta_true + noise, and non-unit plam, ptau and mu."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, p))
    if intercept:
        X[:, 0] = 1.0
    y = X @ rng.normal(size=p) + noise * rng.normal(size=N)
    return X, y, dict(plam_diag=rng.uniform(0.5, 2.0, p), ptau_diag=rng.uniform(0.5, 2.0, N),
                      mu=0.3 * rng.normal(size=p))


def assert_same_draws(got, want, what):
    for name in ("beta", "lam", "tau"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {name}")
    lp_t, lp_j = got["log_post"].numpy(), np.asarray(want["log_post"])
    assert np.all(np.abs(lp_t - lp_j) <= 1e-4 * np.maximum(1.0, np.abs(lp_j))), (what, lp_t, lp_j)


@pytest.mark.parametrize("p,n_thin,hyp", [(2, 2, {}), (5, 1, dict(a_tau=2.0, b_tau=1.0, a_lam=20.0, b_lam=2.0))],
                         ids=["p2_thin2_weak_priors", "p5_thin1_informative_priors"])
def test_k6_plain_matches_jax(host_stats, p, n_thin, hyp):  # noqa: F811
    """(a) 37 chains (ragged against BLOCK_B), 3 burn-in sweeps and 4 stored
    draws; the default Gamma(1e-3, 1e-3) priors (lam's conditional shape near 1:
    six Marsaglia-Tsang rounds) and informative ones (three)."""
    X, y, extra = regression(40, p, 0.3, seed=p, intercept=True)
    kw = dict(n_burn=3, n_iter=4, n_chains=37, n_thin=n_thin, **extra, **hyp)
    want = jlinreg.run_fused_linreg(3, X, y, **kw)
    got = tlinreg.run_fused_linreg(3, X, y, **kw, device="cpu", bit_source=k6_bits(3, p))
    assert got["beta"].shape == (37, 4, p) and got["lam"].shape == (37, 4)
    assert_same_draws(got, want, f"K6 p={p}")


@pytest.mark.parametrize("a_star", [50.001, 1.001, 0.7], ids=["tau_cell", "lam_cell", "shape_below_1"])
def test_gamma_value_before_the_rate_is_the_single_draw(a_star):
    """The identity K6's workers rest on: the Marsaglia-Tsang value made from the
    Philox words alone (rate 1), divided by the rate afterwards, is the plain
    single draw ``gamma_mt(a_star, rate, bits)`` on the same bits, bit for bit:
    at example 3's shapes (a_tau + N/2 and a_lam + p/2 under Gamma(1e-3, 1e-3)
    with N 100, p 2), at a shape below 1 (the boost) and at rates from 1e-3 to
    1e4, over 4096 chains of one sweep."""
    from openmcmc_tpu_torch.fused import prng

    spec = prng._single_spec(a_star, 1)
    widths = [1] * (2 * spec.rounds + spec.boost)
    rate = torch.logspace(-3.0, 4.0, 4096, dtype=torch.float32)[:, None]
    bits = prng.sweep_bits(2**31 + 7919, 4096, 123, widths, "cpu")
    unit = prng.gamma_mt(a_star, torch.ones_like(rate), prng.SiteStream(bits))
    want = prng.gamma_mt(a_star, rate, prng.SiteStream(bits))
    assert bool(torch.all(torch.isfinite(want))) and bool(torch.all(want > 0.0))
    assert torch.equal(unit / rate, want)


def test_k5_plain_matches_jax(host_stats):  # noqa: F811
    """(b) test_spectral.py's problem (N = 80, p = 24, non-unit plam, ptau, mu),
    40 chains, n_thin 2, with noise sd 1.0 in y instead of 0.1. At 0.1 the
    form y'Py - 2 cv'w + w'Sw cancels about 3000-fold, and XLA's CPU backend
    contracts multiply-adds into FMAs (jit(a * b + c) equals fma(a, b, c)), which
    the plain version, like the kernel, does not: tau then differs by ~1e-3
    relative from rounding alone. At 1.0 they agree within 1.3e-5."""
    X, y, extra = regression(80, 24, 1.0, seed=0)
    kw = dict(n_burn=3, n_iter=5, n_chains=40, n_thin=2, **extra)
    want = jspectral.run_spectral_linreg(7, X, y, **kw)
    got = tspectral.run_spectral_linreg(7, X, y, **kw, device="cpu", bit_source=k5_bits(7, 24))
    assert got["beta"].shape == (40, 5, 24)
    assert_same_draws(got, want, "K5 p=24")


def test_host_preparation_matches_jax():
    """(c) K5's f64 preparation equals the JAX package's bit for bit (the same
    numpy calls); K6's float32 sufficient statistics are within 1e-6 of the JAX
    package's, relative to each statistic's largest entry (matmuls and sums over
    N = 100 in two libraries' orders; G's small off-diagonal entries cancel)."""
    X, y, extra = regression(100, 24, 0.5, seed=1)
    prep = tspectral.prepare_linreg(X, y, **extra)
    plam, ptau, mu = extra["plam_diag"], extra["ptau_diag"], extra["mu"]
    XtP = X.T * ptau[None, :]
    V, s = jspectral._eigenbasis(XtP @ X, plam)
    np.testing.assert_array_equal(prep["V"], V)
    np.testing.assert_array_equal(prep["s"], s)
    np.testing.assert_array_equal(prep["wmu"], V.T @ (plam * mu))
    np.testing.assert_array_equal(prep["cv"], V.T @ (XtP @ y))
    assert prep["yPy"] == float(np.sum(y * ptau * y)) and prep["n_obs"] == 100
    assert prep["logdet_plam"] == float(np.sum(np.log(plam))) and prep["logdet_ptau"] == float(np.sum(np.log(ptau)))

    Xs, plam_s = X[:, :5].astype(np.float32), plam[:5].astype(np.float32)
    y32, ptau32 = y.astype(np.float32), ptau.astype(np.float32)
    XtPj = jnp.asarray(Xs).T * jnp.asarray(ptau32)[None, :]
    want = [np.asarray(jnp.matmul(XtPj, jnp.asarray(Xs), precision=jax.lax.Precision.HIGHEST)),
            np.asarray(jnp.matmul(XtPj, jnp.asarray(y32)[:, None], precision=jax.lax.Precision.HIGHEST)).reshape(-1),
            np.array([float(jnp.sum(jnp.asarray(y32 * ptau32 * y32))), float(jnp.sum(jnp.log(plam_s))),
                      float(jnp.sum(jnp.log(ptau32)))], np.float32)]
    got = tlinreg.sufficient_statistics(*(torch.from_numpy(v) for v in (Xs, y32, plam_s, ptau32)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.max(np.abs(g.numpy() - w)) <= 1e-6 * np.max(np.abs(w)), (g, w)


def port_model(response=None):
    from openmcmc_tpu_torch import Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.parameters import LinearCombination, ScaledMatrix

    return Model([
        Normal("y", mean=LinearCombination(form={"beta": "X"}), precision=ScaledMatrix("P_tau", "tau")),
        Normal("beta", mean="mu", precision=ScaledMatrix("P_lambda", "lambda")),
        Gamma("tau", shape="a_tau", rate="b_tau"),
        Gamma("lambda", shape="a_lambda", rate="b_lambda"),
    ], response=response)


@pytest.mark.parametrize("engine", ["fused_linreg", "fused_linreg_spectral"])
def test_log_post_is_model_log_p(engine):
    """(d) Each engine's analytic log_post equals the port's Model.log_p
    (Normal with a LinearCombination mean, chain-batched) at every stored
    draw, 8 chains x 4 draws on Philox bits, within 1e-4 relative."""
    from openmcmc_tpu_torch.linalg import structured as st

    p = 3 if engine == "fused_linreg" else 24
    X, y, extra = regression(60, p, 1.0, seed=2)
    hyp = dict(a_tau=2.0, b_tau=1.0, a_lam=1.5, b_lam=0.5)
    run = tlinreg.run_fused_linreg if engine == "fused_linreg" else tspectral.run_spectral_linreg
    out = run(11, X, y, n_burn=2, n_iter=4, n_chains=8, **hyp, **extra, device="cpu")
    f32 = dict(dtype=torch.float32)
    n = 8 * 4
    state = {
        "y": torch.tensor(y, **f32).reshape(-1, 1), "X": torch.tensor(X, **f32),
        "P_tau": st.Diagonal(torch.tensor(extra["ptau_diag"], **f32)),
        "P_lambda": st.Diagonal(torch.tensor(extra["plam_diag"], **f32)),
        "mu": torch.tensor(extra["mu"], **f32).reshape(-1, 1),
        **{k: torch.full((1, 1), v) for k, v in (("a_tau", 2.0), ("b_tau", 1.0), ("a_lambda", 1.5),
                                                  ("b_lambda", 0.5))},
        "beta": out["beta"].reshape(n, p, 1), "lambda": out["lam"].reshape(n, 1, 1), "tau": out["tau"].reshape(n, 1, 1),
    }
    want = port_model().log_p(state).numpy()
    got = out["log_post"].reshape(-1).numpy()
    assert want.shape == (n,) and np.all(np.isfinite(want))
    assert np.all(np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))), (got, want)


def build(pkg, state, response=None, extra_term=False, truncated=False, n_chains=8, n_burn=3, n_iter=5, seed=5,
          **kw):
    """Reference example 3's model in either package (they share class names)."""
    dist = importlib.import_module(f"{pkg}.distributions")
    params = importlib.import_module(f"{pkg}.parameters")
    smp = importlib.import_module(f"{pkg}.samplers")
    Model = importlib.import_module(f"{pkg}.model").Model
    MCMC = importlib.import_module(f"{pkg}.mcmc").MCMC
    box = dict(domain_response_lower=-10.0) if truncated else {}
    terms = [
        dist.Normal("y", mean=params.LinearCombination(form={"beta": "X"}), precision=params.ScaledMatrix("P_tau", "tau")),
        dist.Normal("beta", mean="mu", precision=params.ScaledMatrix("P_lambda", "lambda"), **box),
        dist.Gamma("tau", shape="a_tau", rate="b_tau"),
        dist.Gamma("lambda", shape="a_lambda", rate="b_lambda"),
    ]
    if extra_term:
        terms.append(dist.Gamma("zeta", shape="a_tau", rate="b_tau"))
    mdl = Model(terms, response=response)
    samplers = [smp.NormalNormal("beta", mdl), smp.NormalGamma("tau", mdl), smp.NormalGamma("lambda", mdl)]
    return MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains, seed=seed, **kw)


def reference_state(X, y, dense_ptau=False, vector_hyper=False):
    from openmcmc_tpu.linalg import structured as jst

    N, p = X.shape
    return {
        "y": y, "X": X, "beta": np.zeros(p), "tau": 1.0, "lambda": 0.01, "mu": np.zeros(p), "zeta": 1.0,
        "P_tau": jst.Dense(jnp.eye(N)) if dense_ptau else jst.Diagonal(jnp.ones(N)),
        "P_lambda": jst.Diagonal(jnp.ones(p)), "a_tau": np.full(2, 1e-3) if vector_hyper else 1e-3,
        "b_tau": 1e-3, "a_lambda": 1e-3, "b_lambda": 1e-3,
    }


def test_dispatch_matches_jax():
    """(f) match_fused_engine in both packages picks the same engine or none:
    p = 2 and 24 match, p = 300 (past the spectral engine), a Dense noise
    precision, an extra model term, a truncated prior and a vector
    hyperparameter do not. Malformed kernel inputs raise."""
    from openmcmc_tpu.fused.dispatch import match_fused_engine as jmatch
    from openmcmc_tpu_torch.convert import state_from_reference
    from openmcmc_tpu_torch.fused.dispatch import match_fused_engine as tmatch

    cases = [(2, {}, {}, "fused_linreg"), (24, {}, {}, "fused_linreg_spectral"), (300, {}, {}, None),
             (2, dict(dense_ptau=True), {}, None), (2, {}, dict(extra_term=True), None),
             (24, {}, dict(truncated=True), None), (2, dict(vector_hyper=True), {}, None)]
    rng = np.random.default_rng(3)
    for p, state_kw, model_kw, want in cases:
        X = rng.normal(size=(40, p))
        state = reference_state(X, X @ rng.normal(size=p), **state_kw)
        j = jmatch(build("openmcmc_tpu", state, **model_kw))
        t = tmatch(build("openmcmc_tpu_torch", state_from_reference(state, device="cpu"), device="cpu", **model_kw))
        assert getattr(j, "engine_name", None) == getattr(t, "engine_name", None) == want, (p, state_kw, model_kw)
        if t is not None:
            assert t.store_keys == j.store_keys == frozenset({"beta", "lambda", "tau"})

    G, c, scal = (torch.ones(2, 2), torch.ones(2), torch.ones(3))
    rows = (torch.ones(4), torch.ones(4))
    kw = dict(n_obs=10.0, a_lam=1.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, n_burn=0, n_keep=1)
    with pytest.raises(ValueError, match="mu must have shape"):
        tlinreg.linreg_sweeps(0, G, c, c, torch.ones(3), scal, *rows, **kw)
    with pytest.raises(ValueError, match="p <= 16"):
        tlinreg.linreg_sweeps(0, torch.ones(17, 17), *(torch.ones(17),) * 3, scal, *rows, **kw)
    with pytest.raises(ValueError, match="CPU only"):
        tlinreg.linreg_sweeps_plain(0, G.to("meta"), *(v.to("meta") for v in (c, c, c, scal, *rows)),
                                    bit_source=lambda *a: None, **kw)


@pytest.mark.parametrize("p,engine", [(2, "fused_linreg"), (20, "fused_linreg_spectral")])
def test_auto_run_stores_fitted_values(p, engine):
    """(f) MCMC.run(engine="auto") with response={"y": "mean"}: the matched
    engine, the store contract, y_fitted equal to X @ beta of the store, and the
    generic driver's _record of the same predictor."""
    from openmcmc_tpu_torch.convert import state_from_reference

    rng = np.random.default_rng(p)
    X = rng.normal(size=(30, p))
    state = state_from_reference(reference_state(X, X @ rng.normal(size=p) + 0.5 * rng.normal(size=30)),
                                 device="cpu")
    mcmc = build("openmcmc_tpu_torch", state, response={"y": "mean"}, device="cpu")
    for res, name in ((mcmc.run(engine="auto"), engine), (mcmc.run(), "generic")):
        assert res.engine == name
        shapes = {"beta": (8, 5, p, 1), "lambda": (8, 5, 1, 1), "tau": (8, 5, 1, 1), "y_fitted": (8, 5, 30, 1)}
        assert {k: tuple(v.shape) for k, v in res.store.items()} == shapes
        assert torch.equal(res.store["y_fitted"], torch.matmul(mcmc.data["X"], res.store["beta"]))
        assert bool(torch.all(torch.isfinite(res.log_post)))


@pytest.fixture(scope="module")
def generic_problem():
    """test_fused_engines_cpu_stats.py's linreg problem and its JAX generic run."""
    from test_fused_engines_cpu_stats import _generic_linreg

    rng = np.random.default_rng(42)
    N, p = 40, 2
    X = np.column_stack([np.ones(N), np.sort(rng.random(N))])
    y = X @ np.array([2.0, 0.5]) + 0.3 * rng.normal(size=N)
    hyp = dict(a_tau=2.0, b_tau=1.0, a_lam=2.0, b_lam=1.0)
    return X, y, hyp, _generic_linreg(X, y, hyp)


@pytest.mark.parametrize("route", ["generic", "k6_plain"])
def test_posterior_matches_jax_generic(generic_problem, route):
    """(e) The port's generic driver (dense NormalNormal on the LinearCombination
    mean; 128 chains, 200 burn-in, 400 stored) and its K6 plain engine on its
    own Philox bits (1024 chains, 50 burn-in, 150 stored: an exact conditional
    draw needs little burn-in) sample the posterior of the JAX generic driver,
    with the thresholds of test_fused_engines_cpu_stats.py: means within 0.1 sd,
    sds within 8 % for beta and 10 % for tau and lam."""
    X, y, hyp, gen = generic_problem
    p = X.shape[1]
    if route == "generic":
        from openmcmc_tpu_torch.linalg import structured as st
        from openmcmc_tpu_torch.samplers import NormalGamma, NormalNormal
        from openmcmc_tpu_torch import MCMC

        mdl = port_model()
        state = {"y": y, "X": X, "beta": np.zeros(p), "mu": np.zeros(p), "P_tau": st.Diagonal(torch.ones(len(y))),
                 "P_lambda": st.Diagonal(torch.ones(p)), "tau": 1.0, "lambda": 1.0, "a_tau": hyp["a_tau"],
                 "b_tau": hyp["b_tau"], "a_lambda": hyp["a_lam"], "b_lambda": hyp["b_lam"]}
        res = MCMC(state, [NormalNormal("beta", mdl), NormalGamma("tau", mdl), NormalGamma("lambda", mdl)], mdl,
                   n_burn=200, n_iter=400, n_chains=128, seed=5, device="cpu").run()
        assert res.engine == "generic"
        draws = {"beta": res.store["beta"][..., 0], "tau": res.store["tau"], "lam": res.store["lambda"]}
    else:
        draws = tlinreg.run_fused_linreg(9, X, y, n_burn=50, n_iter=150, n_chains=1024, device="cpu", **hyp)
    b_f = draws["beta"].numpy().reshape(-1, p)
    b_g = np.asarray(gen.store["beta"]).reshape(-1, p)
    sd = b_g.std(0)
    assert np.all(np.abs(b_f.mean(0) - b_g.mean(0)) < 0.1 * sd), (b_f.mean(0), b_g.mean(0))
    assert np.all(np.abs(b_f.std(0) / sd - 1.0) < 0.08)
    for name in ("tau", "lam"):
        f = draws[name].numpy().reshape(-1)
        g = np.asarray(gen.store[name]).reshape(-1)
        assert abs(f.mean() - g.mean()) < 0.1 * g.std(), name
        assert abs(f.std() / g.std() - 1.0) < 0.1, name


@pytest.mark.parametrize("p,cols", [(1, 128), (100, 128), (128, 128), (129, 256), (256, 256)])
def test_store_operand_follows_p(p, cols):
    """V' for the store kernel takes the narrowest column tile that holds p (128
    up to p = 128, so K1's p = 100 computes 28 masked columns instead of 156),
    its rows rounded up to the 16-row k-tile, V' in the top-left block."""
    V = torch.randn(p, p, generator=torch.Generator().manual_seed(p))
    vt = tspectral.store_operand(V)
    assert tuple(vt.shape) == (-(-p // 16) * 16, cols) and vt.dtype == torch.float32
    assert torch.equal(vt[:p, :p], V.t())


@pytest.mark.parametrize("case", ["cpu", "non_contiguous", "p_above_256"])
def test_spectral_store_kernel_refuses(case):
    """The store kernel's wrapper (K5's and K9's beta = V w over the stored rows)
    launches only on contiguous float32 CUDA rows with p <= 256, and raises before
    it builds anything on any other input."""
    p = 257 if case == "p_above_256" else 8
    V = torch.eye(p)
    rows = torch.zeros((5, p)) if case != "non_contiguous" else torch.zeros((p, 5)).t()
    match = {"cpu": "CUDA device", "non_contiguous": "contiguous", "p_above_256": "p <= 256"}[case]
    before = profiling.counters().get("launch.spectral_store", 0)
    with pytest.raises(ValueError, match=match):
        tspectral.spectral_store_kernel(rows, V)
    assert profiling.counters().get("launch.spectral_store", 0) == before
