"""The port's fused Metropolis engines against the JAX package's: random-walk MH
(kernel K7's plain version, ``fused/random_walk.py``), constant-metric mMALA
with a precomputed Cholesky (K8, ``fused/mmala.py``) and in eigencoordinates
(K9, ``fused/spectral.py``), log_post against ``Model.log_p``, the dispatch
decisions and the statistics the fused runners return.

The JAX engines run their Pallas kernels in interpret mode with a host bit
source (see tests/test_torch_spectral.py); the port's plain versions take the
same bits, the first rows and chains of grid program 0, and must reproduce the
JAX draws within rtol 1e-4, atol 1e-5 (log_post 1e-4 relative, every accept
decision equal). The problems cancel little: XLA's CPU backend contracts
multiply-adds into FMAs, which the plain versions, like the kernels, do not.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmcmc_tpu.fused import mmala as jmmala
from openmcmc_tpu.fused import random_walk as jrw
from openmcmc_tpu.fused import spectral as jspectral
from openmcmc_tpu_torch.fused import mmala as tmmala
from openmcmc_tpu_torch.fused import random_walk as trw
from openmcmc_tpu_torch.fused import spectral as tspectral
from test_torch_linreg import kernel_bits
from test_torch_spectral import host_stats  # noqa: F401  (a fixture)

torch.set_num_threads(2)


def rw_trunc_bits(seed, p):
    """K7's truncated bits: the JAX kernel draws p single-row uniform sites, then
    the accept site; the port's site 0 holds the p uniforms, site 1 the accept
    uniform."""
    jax_bits = kernel_bits(seed, 1, jrw.BLOCK_B)

    def source(it, site, shape):
        chains, width = shape
        if site == 0:
            return torch.cat([jax_bits(it, i, (chains, 1)) for i in range(width)], dim=1)
        return jax_bits(it, p, shape)

    return source


def assert_same(got, want, draw, what):
    np.testing.assert_allclose(got[draw].numpy(), np.asarray(want[draw]), rtol=1e-4, atol=1e-5,
                               err_msg=f"{what} {draw}")
    np.testing.assert_array_equal(got["accept"].numpy(), np.asarray(want["accept"]), err_msg=f"{what} accept")
    np.testing.assert_array_equal(got["accept_total"].numpy(), np.asarray(want["accept_total"]))
    np.testing.assert_allclose(got["log_step"].numpy(), np.asarray(want["log_step"]), rtol=1e-5, atol=1e-6)
    lp_t, lp_j = got["log_post"].numpy(), np.asarray(want["log_post"])
    assert np.all(np.abs(lp_t - lp_j) <= 1e-4 * np.maximum(1.0, np.abs(lp_j))), (what, lp_t, lp_j)


def rw_problem(p, seed):
    """y on a grid of quarters (its sums are exact in float32), non-unit
    per-dimension tau, lam, mu and steps."""
    rng = np.random.default_rng(seed)
    y = rng.integers(-8, 9, (p, 6)) / 4.0
    return y, dict(mu=0.25 * rng.normal(size=p), tau=rng.uniform(0.5, 2.0, p), lam=rng.uniform(0.5, 2.0, p),
                   step=rng.uniform(0.3, 0.8, p), h0=0.1 * rng.normal(size=p))


@pytest.mark.parametrize("variant", ["plain", "truncated", "adapting"])
def test_k7_plain_matches_jax(host_stats, variant):  # noqa: F811
    """(a) p = 3, 37 chains (ragged against BLOCK_B), n_thin 2: Gaussian
    proposals; truncated proposals on a box the chains press against; and
    Robbins-Monro adaptation over 4 burn-in sweeps."""
    p = 3
    y, kw = rw_problem(p, seed=4)
    kw.update(n_burn=4, n_iter=3, n_chains=37, n_thin=2)
    bits = kernel_bits(5, p, jrw.BLOCK_B)
    if variant == "truncated":
        kw["domain"] = (np.full(p, -0.4), np.full(p, 0.6))
        bits = rw_trunc_bits(5, p)
    if variant == "adapting":
        kw.update(adapt_step=True, target_accept=0.3, adapt_rate=0.1)
    want = jrw.run_fused_rw(5, y, **kw)
    got = trw.run_fused_rw(5, y, **kw, device="cpu", bit_source=bits)
    assert got["h"].shape == (37, 3, p) and got["log_post"].shape == (37, 3) and got["log_step"].shape == (37,)
    assert_same(got, want, "h", f"K7 {variant}")
    if variant == "truncated":
        assert float(got["h"].min()) >= -0.4 and float(got["h"].max()) <= 0.6


def regression(N, p, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, p)) / np.sqrt(p)
    y = X @ rng.normal(size=p) + rng.normal(size=N)
    return X, y, dict(ptau_diag=rng.uniform(0.5, 2.0, N), plam_diag=rng.uniform(0.5, 2.0, p),
                      mu0=0.3 * rng.normal(size=p), beta0=0.2 * rng.normal(size=p))


@pytest.mark.parametrize("p,adapt", [(2, False), (9, True)], ids=["p2_unrolled", "p9_looped_adapting"])
def test_k8_plain_matches_jax(host_stats, p, adapt):  # noqa: F811
    """(b) p = 2 and p = 9, either side of the kernel's unroll split (8), 37
    chains; p = 9 adapts its step. The port prepares A, L and c in float64 on
    the host where the JAX package uses float32 device arithmetic, so the two
    agree to float32 rounding of the constants."""
    X, y, extra = regression(40, p, seed=p)
    kw = dict(n_burn=2, n_iter=2, n_chains=37, n_thin=2, tau=1.5, lam=0.7, step=0.6, **extra)
    if adapt:
        kw.update(adapt_step=True, target_accept=0.5, adapt_rate=0.1)
    want = jmmala.run_fused_mmala(9, X, y, **kw)
    got = tmmala.run_fused_mmala(9, X, y, **kw, device="cpu", bit_source=kernel_bits(9, p, jmmala.BLOCK_B))
    assert got["beta"].shape == (37, 2, p)
    assert_same(got, want, "beta", f"K8 p={p}")


def test_k9_plain_matches_jax(host_stats):  # noqa: F811
    """(c) p = 24 with an adapting step, 40 chains, n_thin 2; the JAX kernel
    draws p rounded up to 8 normals per sweep, of which the port takes p."""
    p = 24
    X, y, extra = regression(80, p, seed=1)
    kw = dict(n_burn=4, n_iter=3, n_chains=40, n_thin=2, tau=1.5, lam=0.7, step=0.5, adapt_step=True,
              target_accept=0.5, adapt_rate=0.1, **extra)
    p_pad = p + (-p) % jspectral.PAD
    want = jspectral.run_spectral_mmala(3, X, y, **kw)
    got = tspectral.run_spectral_mmala(3, X, y, **kw, device="cpu",
                                       bit_source=kernel_bits(3, p_pad, jspectral._block_b(p_pad)))
    assert got["beta"].shape == (40, 3, p)
    assert_same(got, want, "beta", "K9 p=24")


def test_host_preparation_matches_jax():
    """(d) K9's float64 preparation is the JAX package's, bit for bit (the same
    numpy calls); K8's float64 A, L and c are within float32 rounding of the
    JAX package's float32 ones."""
    X, y, extra = regression(60, 24, seed=2)
    prep = tspectral.prepare_mmala(X, y, tau=1.5, lam=0.7, **extra)
    plam, ptau = extra["plam_diag"], extra["ptau_diag"]
    XtP = X.T * ptau[None, :]
    V, s = jspectral._eigenbasis(XtP @ X, plam)
    np.testing.assert_array_equal(prep["V"], V)
    np.testing.assert_array_equal(prep["d"], 1.5 * s + 0.7)
    np.testing.assert_array_equal(prep["w0"], V.T @ (plam * extra["beta0"]))

    X, y, extra = regression(60, 5, seed=3)
    got = tmmala.prepare(X, y, tau=1.5, lam=0.7, **extra)
    A = 1.5 * (X.T * extra["ptau_diag"]) @ X + 0.7 * np.diag(extra["plam_diag"])
    np.testing.assert_allclose(got["scal"][:25].reshape(5, 5), A, rtol=1e-6)
    np.testing.assert_allclose(got["scal"][25:50].reshape(5, 5), np.linalg.cholesky(A), rtol=1e-6, atol=1e-7)
    assert got["scal"].dtype == np.float32 and got["scal"].shape == (2 * 25 + 3 * 5 + 4,)


def port_mh_model(kind):
    from openmcmc_tpu_torch import Model
    from openmcmc_tpu_torch.distributions import Normal
    from openmcmc_tpu_torch.parameters import LinearCombination, ScaledMatrix

    if kind == "rw":
        return Model([Normal("y", mean="h", precision="tau"), Normal("h", mean="mu", precision="lambda")])
    return Model([Normal("y", mean=LinearCombination(form={"beta": "X"}), precision=ScaledMatrix("P", "tau")),
                  Normal("beta", mean="mu0", precision=ScaledMatrix("P0", "lam"))])


@pytest.mark.parametrize("engine", ["fused_random_walk", "fused_mmala", "fused_mmala_spectral"])
def test_log_post_is_model_log_p(engine):
    """(e) Each engine's carried log_post equals the port's Model.log_p at every
    stored draw, 8 chains x 4 draws on Philox bits, within 1e-4 relative."""
    from openmcmc_tpu_torch.linalg import structured as st

    f32 = dict(dtype=torch.float32)
    if engine == "fused_random_walk":
        p = 3
        y, kw = rw_problem(p, seed=6)
        out = trw.run_fused_rw(2, y, n_burn=3, n_iter=4, n_chains=8, **kw, device="cpu")
        state = {"y": torch.tensor(y, **f32), "tau": st.Diagonal(torch.tensor(kw["tau"], **f32)),
                 "lambda": st.Diagonal(torch.tensor(kw["lam"], **f32)),
                 "mu": torch.tensor(kw["mu"], **f32).reshape(-1, 1), "h": out["h"].reshape(32, p, 1)}
        want = port_mh_model("rw").log_p(state)
    else:
        p = 4 if engine == "fused_mmala" else 20
        X, y, extra = regression(50, p, seed=p)
        run = tmmala.run_fused_mmala if engine == "fused_mmala" else tspectral.run_spectral_mmala
        out = run(2, X, y, n_burn=3, n_iter=4, n_chains=8, tau=1.5, lam=0.7, step=0.5, **extra, device="cpu")
        state = {"y": torch.tensor(y, **f32).reshape(-1, 1), "X": torch.tensor(X, **f32),
                 "P": st.Diagonal(torch.tensor(extra["ptau_diag"], **f32)), "tau": torch.full((1, 1), 1.5),
                 "P0": st.Diagonal(torch.tensor(extra["plam_diag"], **f32)), "lam": torch.full((1, 1), 0.7),
                 "mu0": torch.tensor(extra["mu0"], **f32).reshape(-1, 1), "beta": out["beta"].reshape(32, p, 1)}
        want = port_mh_model("mmala").log_p(state)
    got = out["log_post"].reshape(-1)
    assert want.shape == (32,) and bool(torch.all(torch.isfinite(want)))
    assert bool(torch.all(torch.abs(got - want) <= 1e-4 * torch.clamp(torch.abs(want), min=1.0))), (got, want)


def build(pkg, kind, state, sampler_kw=None, extra_term=False, loop=False, n_chains=8, n_burn=3, n_iter=4, seed=5,
          **kw):
    """The random-walk or mMALA model in either package (they share class names)."""
    dist = importlib.import_module(f"{pkg}.distributions")
    params = importlib.import_module(f"{pkg}.parameters")
    smp = importlib.import_module(f"{pkg}.samplers")
    Model = importlib.import_module(f"{pkg}.model").Model
    MCMC = importlib.import_module(f"{pkg}.mcmc").MCMC
    if kind == "rw":
        terms = [dist.Normal("y", mean="h", precision="tau"), dist.Normal("h", mean="mu", precision="lambda")]
        name, cls = "h", smp.RandomWalkLoop if loop else smp.RandomWalk
    else:
        terms = [dist.Normal("y", mean=params.LinearCombination(form={"beta": "X"}),
                             precision=params.ScaledMatrix("P", "tau")),
                 dist.Normal("beta", mean="mu0", precision=params.ScaledMatrix("P0", "lam"))]
        name, cls = "beta", smp.ManifoldMALA
    if extra_term:
        terms.append(dist.Gamma("zeta", shape="a", rate="a"))
    mdl = Model(terms)
    return MCMC(state, [cls(name, mdl, **(sampler_kw or {}))], mdl, n_burn=n_burn, n_iter=n_iter,
                n_chains=n_chains, seed=seed, **kw)


def rw_state(p, dense_tau=False, h_cols=1):
    from openmcmc_tpu.linalg import structured as jst

    rng = np.random.default_rng(p)
    tau = jnp.asarray(rng.uniform(0.5, 2.0, (p, p))) if dense_tau else jst.Diagonal(jnp.full(p, 1.5))
    return {"y": rng.normal(size=(p, 5)), "h": np.zeros((p, h_cols)), "tau": tau, "mu": np.zeros((p, 1)),
            "lambda": jst.Diagonal(jnp.full(p, 0.5)), "a": 1.0, "zeta": 1.0}


def mmala_state(p, dense_p=False, vector_tau=False):
    from openmcmc_tpu.linalg import structured as jst

    rng = np.random.default_rng(p)
    N = 30
    X = rng.normal(size=(N, p))
    return {"y": (X @ rng.normal(size=p) + rng.normal(size=N)).reshape(-1, 1), "X": X, "beta": np.zeros((p, 1)),
            "P": jst.Dense(jnp.eye(N)) if dense_p else jst.Diagonal(jnp.ones(N)),
            "tau": np.ones(2) if vector_tau else 1.0, "P0": jst.Diagonal(jnp.full(p, 0.5)), "lam": 1.0,
            "mu0": np.zeros((p, 1)), "a": 1.0, "zeta": 1.0}


DISPATCH_CASES = [
    ("rw", rw_state(1), {"step": 0.5}, {}, "fused_random_walk"),
    ("rw", rw_state(32), {"step": np.linspace(0.1, 0.2, 32)[:, None], "domain_limits": [[-3.0, 3.0]],
                          "adapt_step": True}, {}, "fused_random_walk"),
    ("rw", rw_state(33), {}, {}, None),
    ("rw", rw_state(3, dense_tau=True), {}, {}, None),
    ("rw", rw_state(3, h_cols=2), {}, {}, None),
    ("rw", rw_state(3), {"domain_limits": [[0.0, 3.0]]}, {}, None),
    ("rw", rw_state(3), {}, {"extra_term": True}, None),
    ("rw", rw_state(3), {}, {"loop": True}, None),
    ("mmala", mmala_state(5), {"step": 0.8}, {}, "fused_mmala"),
    ("mmala", mmala_state(24), {"adapt_step": True}, {}, "fused_mmala_spectral"),
    ("mmala", mmala_state(300), {}, {}, None),
    ("mmala", mmala_state(5, dense_p=True), {}, {}, None),
    ("mmala", mmala_state(5, vector_tau=True), {}, {}, None),
    ("mmala", mmala_state(5), {"step": np.array([[0.5], [0.6], [0.5], [0.5], [0.5]])}, {}, None),
    ("mmala", mmala_state(5), {}, {"extra_term": True}, None),
    ("rw", rw_state(4), {"step": np.linspace(0.1, 0.2, 4)[:, None], "domain_limits": [[-3.0, 3.0]],
                         "adapt_step": True}, {}, "fused_random_walk"),
]


def test_dispatch_matches_jax():
    """(f) match_fused_engine in both packages picks the same engine or none:
    the reference's example 2 shape (p = 1), p = 32 with per-dimension steps, a
    box and adaptation, and mMALA at p = 5 and 24 match; p = 33, a dense noise
    precision, replicated h columns, a start on the box's edge, an extra model
    term, RandomWalkLoop, p = 300, a Dense P, a vector tau and a vector mMALA
    step do not. Malformed kernel inputs raise."""
    from openmcmc_tpu.fused.dispatch import match_fused_engine as jmatch
    from openmcmc_tpu_torch.convert import state_from_reference
    from openmcmc_tpu_torch.fused.dispatch import match_fused_engine as tmatch

    for kind, state, skw, mkw, want in DISPATCH_CASES:
        j = jmatch(build("openmcmc_tpu", kind, state, skw, **mkw))
        t = tmatch(build("openmcmc_tpu_torch", kind, state_from_reference(state, device="cpu"), skw, device="cpu",
                         **mkw))
        assert getattr(j, "engine_name", None) == getattr(t, "engine_name", None) == want, (kind, skw, mkw)
        if t is not None:
            assert t.store_keys == j.store_keys

    with pytest.raises(ValueError, match="p <= 32"):
        trw.rw_sweeps(0, torch.ones(7 * 33), 4, p=33, n_obs=1.0, const=0.0, log_step0=0.0, trunc=False, adapt=False,
                      target=0.2, rate=0.1, n_burn=0, n_keep=1)
    with pytest.raises(ValueError, match="scal must be"):
        tmmala.mmala_sweeps(0, torch.ones(10), 4, p=2, n_obs=1.0, step=1.0, adapt=False, target=0.5, rate=0.1,
                            n_burn=0, n_keep=1)
    with pytest.raises(ValueError, match="CPU only"):
        trw.rw_sweeps_plain(0, torch.ones(7, device="meta"), 2, p=1, n_obs=1.0, const=0.0, log_step0=0.0,
                            trunc=False, adapt=False, target=0.2, rate=0.1, n_burn=0, n_keep=1,
                            bit_source=lambda *a: None)


@pytest.mark.parametrize("case", [0, 15, 8, 9], ids=["rw_p1", "rw_p4_box_adapt", "mmala_p5", "mmala_p24_adapt"])
def test_fused_stats_match_jax_shapes(host_stats, case):  # noqa: F811
    """(g) The matched runners' statistics have the JAX runners' keys, shapes and
    dtypes: accept and proposal (chains,) int32 with the proposal count
    n_burn + n_iter over burn-in and sampling, and the adapted log_step in the
    step's at-least-2-D shape per chain; the store as the generic driver's."""
    from openmcmc_tpu.fused.dispatch import match_fused_engine as jmatch
    from openmcmc_tpu_torch.convert import state_from_reference
    from openmcmc_tpu_torch.fused.dispatch import match_fused_engine as tmatch

    kind, state, skw, mkw, _ = DISPATCH_CASES[case]
    jstore, jlp, jstats = jmatch(build("openmcmc_tpu", kind, state, skw, **mkw))(3)
    mcmc = build("openmcmc_tpu_torch", kind, state_from_reference(state, device="cpu"), skw, device="cpu", **mkw)
    res = mcmc.run(engine="auto")
    assert res.engine == tmatch(mcmc).engine_name
    assert {k: tuple(v.shape) for k, v in res.store.items()} == {k: tuple(v.shape) for k, v in jstore.items()}
    assert tuple(res.log_post.shape) == tuple(jlp.shape)
    for name, sts in jstats.items():
        assert set(res.stats[name]) == set(sts)
        for k, v in sts.items():
            assert tuple(res.stats[name][k].shape) == tuple(v.shape), (name, k)
            assert (res.stats[name][k].dtype == torch.int32) == (v.dtype == jnp.int32), (name, k)
        assert bool(torch.all(res.stats[name]["proposal"] == 3 + 4))
        assert np.array_equal(np.asarray(sts["proposal"]), res.stats[name]["proposal"].numpy())
