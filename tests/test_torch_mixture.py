"""The port's Gaussian mixture against the JAX package's: the mixture parameter
forms, Categorical, the mixture Normal density, the conjugate steps
(MixtureAllocation, NormalNormal over the component means, NormalGamma over the
component precisions), ``gamma_mt_elem``, kernel K10's plain version
(``fused/mixture.py``) against the JAX kernel in interpret mode, the dispatch,
and the whole slice through ``MCMC.run``.

The JAX engine runs its Pallas kernel in interpret mode with a host bit source
(see tests/test_torch_spectral.py); the port's plain version takes the same
bits (:func:`mixture_bits` maps the JAX sites onto the port's) and must
reproduce the JAX draws within rtol 1e-4 and every allocation exactly. The JAX
runs are made once per module (:func:`jax_runs`) and shared by the tests that
read them.
"""

import importlib
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openmcmc_tpu.fused import mixture as jmix
from openmcmc_tpu.fused import prng as jprng
from openmcmc_tpu_torch.diagnostics import ess_per_param
from openmcmc_tpu_torch.fused import mixture as tmix
from openmcmc_tpu_torch.fused import prng as tprng

torch.set_num_threads(2)

PKGS = ("openmcmc_tpu", "openmcmc_tpu_torch")


def _mods(pkg):
    names = ("distributions", "parameters", "samplers", "model", "mcmc", "linalg.structured")
    return [importlib.import_module(f"{pkg}.{m}") for m in names]


def mixture_model(pkg):
    dist, par, _, model, _, _ = _mods(pkg)
    return model.Model([
        dist.Normal("y", mean=par.MixtureParameterVector(param="means", allocation="Z"),
                    precision=par.MixtureParameterMatrix(param="lams", allocation="Z")),
        dist.Categorical("Z", prob="prior"),
        dist.Normal("means", mean="mu0", precision="P0"),
        dist.Gamma("lams", shape="a0", rate="b0"),
    ])


def mixture_data(rng, n, k, replicates=1):
    """Components at linspace(-3, 3), noise sd 0.5, unnormalised weights."""
    alloc = rng.integers(0, k, n)
    y = np.linspace(-3.0, 3.0, k)[alloc][:, None] + rng.normal(0.0, 0.5, (n, replicates))
    return y, rng.uniform(0.2, 1.0, (n, k))


def build(pkg, y, prior, n_burn=2, n_iter=4, n_chains=8, conjugate=False, domain=True, seed=0,
          store=("means", "lams"), a0=2.0, means=None, **kw):
    """bench_all.py's mixture in either package (tests/test_fused_mixture.py's
    _build_mcmc), over given data."""
    _, _, smp, _, mcmc, st = _mods(pkg)
    n, k = prior.shape
    mdl = mixture_model(pkg)
    if conjugate:
        means_sampler = smp.NormalNormal("means", mdl)
    else:
        limits = np.tile([[-20.0, 20.0]], (k, 1)) if domain else None
        means_sampler = smp.RandomWalkLoop("means", mdl, step=0.3, domain_limits=limits)
    samplers = [smp.MixtureAllocation("Z", mdl, response_param="y"), means_sampler, smp.NormalGamma("lams", mdl)]
    diag = jnp.full((k,), 0.01) if pkg == "openmcmc_tpu" else torch.full((k,), 0.01)
    state = {"y": y, "Z": (y[:, :1] > 0).astype(np.int32), "lams": np.ones((k, 1)), "prior": prior,
             "means": np.linspace(-1.0, 1.0, k).reshape(k, 1) if means is None else means,
             "mu0": np.zeros((k, 1)), "P0": st.Diagonal(diag), "a0": np.full((k, 1), a0), "b0": np.ones((k, 1))}
    if pkg == "openmcmc_tpu_torch":
        kw["device"] = "cpu"
    return mcmc.MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains, seed=seed,
                     store_names=list(store), **kw)


def chain_state(rng, n, k, chains):
    """Per-chain Z, means and lams, and the data, as a port state, and a JAX
    reference ``jax_per_chain(fn)``: ``fn(state)`` over every chain's JAX state,
    vmapped and compiled once, as numpy."""
    from openmcmc_tpu.linalg import structured as jst
    from openmcmc_tpu_torch.linalg import structured as tst

    y, prior = mixture_data(rng, n, k, replicates=2)
    per_chain = {"Z": rng.integers(0, k, (chains, n, 1)).astype(np.int32),
                 "means": rng.normal(size=(chains, k, 1)), "lams": rng.uniform(0.5, 2.0, (chains, k, 1))}
    data = {"y": y, "prior": prior, "mu0": rng.normal(size=(k, 1)), "a0": np.full((k, 1), 2.0),
            "b0": np.full((k, 1), 1.5)}
    p0 = rng.uniform(0.5, 2.0, k)
    port = {name: torch.tensor(v) if v.dtype == np.int32 else torch.tensor(v, dtype=torch.float32)
            for name, v in {**data, **per_chain}.items()}
    port["P0"] = tst.Diagonal(torch.tensor(p0, dtype=torch.float32))
    jax_data = {name: jnp.asarray(v, jnp.float32) for name, v in data.items()}
    jax_data["P0"] = jst.Diagonal(jnp.asarray(p0, jnp.float32))
    stacked = {name: jnp.asarray(v) for name, v in per_chain.items()}

    def jax_per_chain(fn):
        out = jax.jit(jax.vmap(lambda chain: fn({**jax_data, **chain})))(stacked)
        return jax.tree_util.tree_map(np.asarray, out)

    return port, jax_per_chain


def test_mixture_forms_match_jax():
    """(a) MixtureParameterVector/Matrix predictors, the element match, the
    gradient and the precision mask, chain-batched (3 chains, each its own
    allocation), equal the JAX package's per chain within rtol 1e-5."""
    from openmcmc_tpu import parameters as jpar
    from openmcmc_tpu_torch import parameters as tpar

    port, jax_per_chain = chain_state(np.random.default_rng(0), n=11, k=4, chains=3)
    tv, jv = tpar.MixtureParameterVector("means", "Z"), jpar.MixtureParameterVector("means", "Z")
    tm, jm = tpar.MixtureParameterMatrix("lams", "Z"), jpar.MixtureParameterMatrix("lams", "Z")
    got = {"vector": tv.predictor(port), "matrix": tm.predictor(port).diag_, "grad": tv.grad(port, "means"),
           "match": tv.get_element_match(port, 2), "matches": tv.get_element_match(port, torch.arange(4)),
           "unscaled": tm.precision_unscaled(port, 1).diag_}
    assert got["vector"].shape == (3, 11, 1) and got["matrix"].shape == (3, 11) and got["grad"].shape == (3, 4, 11)
    assert tv.get_param_list() == jv.get_param_list() and tm.get_grad_param_list() == jm.get_grad_param_list() == []
    want = jax_per_chain(lambda js: {
        "vector": jv.predictor(js), "matrix": jm.predictor(js).diag_, "grad": jv.grad(js, "means"),
        "match": jv.get_element_match(js, 2), "matches": jv.get_element_match(js, jnp.arange(4)),
        "unscaled": jm.precision_unscaled(js, 1).diag_})
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", ["sequence", "by_observation", "aggregated"])
def test_categorical_log_p_matches_jax(case):
    """(b) Categorical.log_p over chain-batched indices with 3 replicate columns:
    the index sequence's probability, per observation, and the reference's
    aggregated multinomial pmf; rtol 1e-5 against the JAX package per chain."""
    from openmcmc_tpu.distributions import Categorical as JCat
    from openmcmc_tpu_torch.distributions import Categorical as TCat

    rng = np.random.default_rng(1)
    x = rng.integers(0, 5, (4, 6, 3)).astype(np.int32)
    prob = rng.uniform(0.1, 1.0, (6, 5))
    prob /= prob.sum(axis=1, keepdims=True)
    by_obs, agg = case == "by_observation", case == "aggregated"
    got = TCat("x", prob="p", aggregated=agg).log_p({"x": torch.tensor(x), "p": torch.tensor(prob, dtype=torch.float32)},
                                                    by_observation=by_obs)
    assert got.shape == ((4, 3) if by_obs else (4,))
    jcat, p = JCat("x", prob="p", aggregated=agg), jnp.asarray(prob, jnp.float32)
    want = jax.jit(jax.vmap(lambda xc: jcat.log_p({"x": xc, "p": p}, by_observation=by_obs)))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, err_msg=case)


def test_mixture_normal_and_model_log_p_match_jax():
    """(c) The mixture Normal's log_p (a per-chain Diagonal precision) and the
    whole mixture model's, 3 chains, rtol 1e-5 against the JAX package."""
    port, jax_per_chain = chain_state(np.random.default_rng(2), n=13, k=3, chains=3)
    tmodel, jmodel = mixture_model("openmcmc_tpu_torch"), mixture_model("openmcmc_tpu")
    got_y, got = tmodel["y"].log_p(port), tmodel.log_p(port)
    assert got_y.shape == got.shape == (3,)
    want_y, want = jax_per_chain(lambda js: (jmodel["y"].log_p(js), jmodel.log_p(js)))
    np.testing.assert_allclose(got_y.numpy(), want_y, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_conjugate_mixture_steps(monkeypatch):
    """(d) On tests/test_mixture_e2e.py:91's problem, per chain of a 2-chain
    state: NormalNormal's conditional over the component means is
    Q = P0 + diag(n_k lam_k), b = P0 mu0 + lam_k sum_{i in k} y_i (Q stays
    Diagonal; with a dense likelihood precision W, Q = P0 + A'WA over the
    one-hot allocation A); NormalGamma's is a* = a0 + n_k r / 2,
    b* = b0 + quad_k / 2; and
    MixtureAllocation's logits equal the JAX sampler's (rtol 1e-5)."""
    from openmcmc_tpu.samplers import MixtureAllocation as JAlloc
    from openmcmc_tpu_torch.linalg import gmrf
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.samplers import MixtureAllocation, NormalGamma, NormalNormal

    n, m = 12, 3
    rng = np.random.default_rng(3)
    y = rng.normal(size=(n, 1))
    alloc = np.stack([np.array([0, 1, 2, 0, 1, 2, 0, 0, 1, 2, 2, 2]), rng.integers(0, m, n)]).astype(np.int32)
    lams = np.array([[2.0, 0.5, 4.0], [1.0, 3.0, 0.7]])
    means = rng.normal(size=(2, m))
    mu0, p0 = np.array([1.0, -1.0, 0.5]), np.array([0.1, 0.2, 0.3])
    f32 = dict(dtype=torch.float32)
    state = {"y": torch.tensor(y, **f32), "Z": torch.tensor(alloc[..., None]), "means": torch.tensor(means[..., None], **f32),
             "lams": torch.tensor(lams[..., None], **f32), "prior": torch.full((n, m), 1.0 / m),
             "mu0": torch.tensor(mu0[:, None], **f32), "P0": st.Diagonal(torch.tensor(p0, **f32)),
             "a0": torch.full((m, 1), 2.0), "b0": torch.ones((m, 1))}
    mdl = mixture_model("openmcmc_tpu_torch")
    key = gmrf.Key(torch.Generator().manual_seed(0))

    captured = {}

    def fake_canonical(key, b, Q=None, L=None):
        captured["b"], captured["Q"] = b, Q
        return st.solve(Q, b)

    monkeypatch.setattr(gmrf, "sample_normal_canonical", fake_canonical)
    new_state, _ = NormalNormal("means", mdl).step(key, state, {})
    assert isinstance(captured["Q"], st.Diagonal) and captured["Q"].diag_.shape == (2, m)
    q_mix, b_mix = captured["Q"].diag_, captured["b"]

    # a dense likelihood precision W takes the one-hot branch: Q = P0 + A'WA, b = P0 mu0 + A'W y
    from openmcmc_tpu_torch.distributions import Normal
    from openmcmc_tpu_torch.model import Model
    from openmcmc_tpu_torch.parameters import MixtureParameterVector

    w = rng.uniform(0.5, 2.0, n)
    dense = Model([Normal("y", mean=MixtureParameterVector("means", "Z"), precision="W"),
                   Normal("means", mean="mu0", precision="P0")])
    NormalNormal("means", dense).step(key, {**state, "W": torch.tensor(np.diag(w), **f32)}, {})
    onehot = np.eye(m)[alloc[1]]
    np.testing.assert_allclose(st.to_dense(captured["Q"])[1].numpy(), np.diag(p0) + onehot.T @ (w[:, None] * onehot),
                               rtol=1e-5)
    np.testing.assert_allclose(captured["b"][1, :, 0].numpy(), p0 * mu0 + onehot.T @ (w * y[:, 0]), rtol=1e-5)

    def fake_gamma(a, generator=None):
        captured["a"] = a
        return torch.ones_like(a)

    monkeypatch.setattr(torch, "_standard_gamma", fake_gamma)
    gamma_state, _ = NormalGamma("lams", mdl).step(key, state, {})
    for c in range(2):
        counts = np.bincount(alloc[c], minlength=m).astype(float)
        sums = np.array([y[alloc[c] == k].sum() for k in range(m)])
        np.testing.assert_allclose(q_mix[c].numpy(), p0 + counts * lams[c], rtol=1e-5)
        np.testing.assert_allclose(b_mix[c, :, 0].numpy(), p0 * mu0 + lams[c] * sums, rtol=1e-5)
        np.testing.assert_allclose(new_state["means"][c, :, 0].numpy(), (p0 * mu0 + lams[c] * sums) / (p0 + counts * lams[c]),
                                   rtol=1e-5)
        quad = np.array([((y[alloc[c] == k, 0] - means[c, k]) ** 2).sum() for k in range(m)])
        np.testing.assert_allclose(captured["a"][c].numpy(), 2.0 + counts / 2.0, rtol=1e-6)
        np.testing.assert_allclose(1.0 / gamma_state["lams"][c, :, 0].numpy(), 1.0 + quad / 2.0, rtol=1e-5)

    jmodel = mixture_model("openmcmc_tpu")
    sampler = MixtureAllocation("Z", mdl, response_param="y")
    logits = sampler.logits(state)
    assert logits.shape == (2, n, m)
    seen = {}

    def fake_categorical(key, logits, axis=-1):
        seen["logits"] = np.asarray(logits)
        return jnp.zeros(logits.shape[0], jnp.int32)

    with mock.patch.object(jax.random, "categorical", fake_categorical):
        for c in range(2):
            js = {"y": jnp.asarray(y, jnp.float32), "Z": jnp.asarray(alloc[c][:, None]),
                  "means": jnp.asarray(means[c][:, None], jnp.float32), "lams": jnp.asarray(lams[c][:, None], jnp.float32),
                  "prior": jnp.full((n, m), 1.0 / m)}
            JAlloc("Z", jmodel, response_param="y").step(jax.random.PRNGKey(0), js, {})
            np.testing.assert_allclose(logits[c].numpy(), seen["logits"], rtol=1e-5)
    draw, _ = sampler.step(key, state, {})
    assert draw["Z"].shape == (2, n, 1) and draw["Z"].dtype == torch.int32


def test_gamma_mt_elem_matches_jax():
    """(e) K2's gamma_mt_elem on the same bits: elementwise shapes in [1, 40],
    six rounds of (normal, uniform) sites; rtol 1e-5 against the JAX function;
    the counter-tensor entry point's plain version reads the same Philox sites
    as the kernel's layout."""
    rng = np.random.default_rng(4)
    a = rng.uniform(1.0, 40.0, (64, 4)).astype(np.float32)
    rate = rng.uniform(0.5, 3.0, (64, 4)).astype(np.float32)
    sites = [rng.integers(0, 2**32, (64, 4), dtype=np.uint64).astype(np.uint32) for _ in range(12)]

    @jax.jit
    def reference(a, rate, sites):
        it = iter(sites)
        return jprng.gamma_mt_elem(a, rate, bit_source=lambda shape: next(it))

    want = reference(jnp.asarray(a), jnp.asarray(rate), tuple(jnp.asarray(b) for b in sites))
    it = iter(sites)
    got = tprng.gamma_mt_elem(torch.tensor(a), torch.tensor(rate), lambda shape: torch.tensor(next(it).astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    ctr = torch.tensor(rng.integers(0, 1000, (16, 4)), dtype=torch.int32)
    out = tprng.gamma_elem_draws(3, ctr, torch.tensor(a[:16]), torch.tensor(rate[:16]))
    words = tprng.gamma_elem_sites(3, ctr)
    assert len(words) == 12 and words[5].shape == (16, 4)
    np.testing.assert_array_equal(out.numpy(), tprng.gamma_mt_elem(torch.tensor(a[:16]), torch.tensor(rate[:16]),
                                                                   tprng.SiteStream(words)).numpy())


def mixture_bits(seed, n, k, conjugate, store_z):
    """The bits the interpret-mode JAX kernel draws in grid program 0 under a
    host bit source, as a port bit source ``(sweep, site, (chains, width))``.
    The JAX kernel folds the sweep into its key and numbers its sites; a
    streamed run takes each tile's uniforms from site 0 of key
    fold_in(sweep key, 1_000_000 + tile) and its later sites from 500. Port site
    0 is the allocation uniforms; the random walk's site 1 the JAX kernel's K
    single-row proposal sites and site 2 its accept site; the conjugate site 1
    the K normals; then the Gamma rounds."""
    stream = n > jmix.RESIDENT_N
    n_pad = n + (-n) % jmix.pad_unit(n)
    tile = jmix.TILE_N if stream else n_pad
    block = jmix._block_b(tile, k, store_z)
    base = jax.random.PRNGKey(seed)
    first = 500 if stream else 1

    def fold(*path):
        key = base
        for v in path:
            key = jax.random.fold_in(key, v)
        return key

    # the bits at key fold_in(...fold_in(base, path[0])..., path[-1]), compiled once per shape
    draw = jax.jit(lambda path, rows: jax.random.bits(fold(*path), (rows, block), jnp.uint32), static_argnums=1)

    def source(it, site, shape):
        chains, width = shape
        if site == 0 and stream:
            bits = np.concatenate([np.asarray(draw((it, 1_000_000 + t, 0), tile)) for t in range(n_pad // tile)])
        elif site == 0:
            bits = np.asarray(draw((it, 0), n_pad))
        elif conjugate:
            bits = np.asarray(draw((it, first + site - 1), width))
        elif site == 1:
            bits = np.concatenate([np.asarray(draw((it, first + i), 1)) for i in range(width)])
        else:
            bits = np.asarray(draw((it, first + k + site - 2), width))
        return torch.from_numpy(bits[:width, :chains].T.astype(np.int64))

    return source


# (K, conjugate means, streamed): each factor at each of its values
K10_CASES = {"rw_k2_resident": (2, False, False), "conjugate_k2_streamed": (2, True, True),
             "conjugate_k16_resident": (16, True, False)}


def k10_kwargs(k, conjugate):
    return dict(n_burn=2, n_iter=3, n_chains=8, n_thin=2, mu0=np.zeros(k), p0=np.full(k, 0.01), a0=np.full(k, 2.0),
                b0=np.ones(k), mu_init=np.linspace(-1.0, 1.0, k), lam_init=np.ones(k), step=0.3,
                domain=(np.full(k, -4.0), np.full(k, 4.0)), conjugate_means=conjugate, store_z=True)


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX interpret-mode run per K10 case, with its data and bit source,
    made on first use; n = 30, 8 chains, 2 + 3 x 2 sweeps, Z stored. The
    streamed case patches RESIDENT_N and TILE_N down (tests/test_fused_mixture.py:337)."""
    cache = {}

    def get(case):
        if case not in cache:
            k, conjugate, stream = K10_CASES[case]
            y, prior = mixture_data(np.random.default_rng(k), 30, k)
            kw = k10_kwargs(k, conjugate)
            patches = [mock.patch.object(jmix, "RESIDENT_N", 16), mock.patch.object(jmix, "TILE_N", 8)] if stream else []
            for p in patches:
                p.start()
            try:
                jax.clear_caches()
                with pltpu.force_tpu_interpret_mode(), jprng.host_bits(jprng.HostBitSource()):
                    want = {name: np.asarray(v) for name, v in jmix.run_fused_mixture(5, y[:, 0], prior, **kw).items()}
                bits = mixture_bits(5, 30, k, conjugate, True)
            finally:
                for p in patches:
                    p.stop()
                jax.clear_caches()
            cache[case] = (y, prior, kw, want, bits)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(K10_CASES))
def test_k10_plain_matches_jax(jax_runs, case):
    """(f) K10's plain version against the JAX kernel in interpret mode on its
    host bits: n = 30, 8 chains, n_thin 2; the random walk with a box at K = 2
    on the resident route, conjugate means at K = 2 on the streamed route and
    at K = 16. means, lams (rtol 1e-4, atol 1e-5), log_post (1e-4 relative),
    the accept counts and every stored allocation equal."""
    y, prior, kw, want, bits = jax_runs(case)
    got = tmix.run_fused_mixture(5, y[:, 0], prior, **kw, device="cpu", bit_source=bits)
    k = prior.shape[1]
    assert got["means"].shape == got["lams"].shape == (8, 3, k) and got["z"].shape == (8, 3, 30)
    assert got["z"].dtype == torch.int32 and got["log_post"].shape == (8, 3)
    for name in ("means", "lams"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-4, atol=1e-5, err_msg=name)
    lp_t, lp_j = got["log_post"].numpy(), want["log_post"]
    assert np.all(np.abs(lp_t - lp_j) <= 1e-4 * np.maximum(1.0, np.abs(lp_j))), (lp_t, lp_j)
    np.testing.assert_array_equal(got["accept_total"].numpy(), want["accept_total"])
    np.testing.assert_array_equal(got["z"].numpy(), want["z"])
    if not kw["conjugate_means"]:
        assert 0 < float(got["accept_total"].sum()) < 8 * 8


@pytest.mark.parametrize("conjugate", [False, True])
def test_k10_log_post_matches_model(conjugate):
    """(g) The plain version's stored log_post equals the port's Model.log_p at
    the stored (Z, means, lams) within 1e-4 relative, with replicate columns."""
    rng = np.random.default_rng(6)
    y, prior = mixture_data(rng, 24, 3, replicates=2)
    kw = k10_kwargs(3, conjugate)
    out = tmix.run_fused_mixture(9, y, prior, **kw, device="cpu")
    mcmc = build("openmcmc_tpu_torch", y, prior, conjugate=conjugate)
    for c in range(3):
        for t in range(3):
            state = dict(mcmc.data)
            state.update({"Z": out["z"][c, t][:, None], "means": out["means"][c, t][:, None],
                          "lams": out["lams"][c, t][:, None]})
            want = float(mcmc.model.log_p(state))
            assert abs(float(out["log_post"][c, t]) - want) <= 1e-4 * max(1.0, abs(want)), (c, t, want)


def _dispatch_cases():
    """(name, y, prior, MCMC keywords, engine): tests/test_fused_mixture.py:75-122's
    routes and near misses, and the Z cap's boundary."""
    rng = np.random.default_rng(7)
    y, prior = mixture_data(rng, 60, 3)
    y3000, prior3000 = mixture_data(rng, 3000, 3)
    y_big_k, prior_big_k = mixture_data(rng, 80, tmix.MAX_K + 1)
    # n = 60 pads to 64 rows and 128 chains to the JAX engine's 2048 lanes, so
    # the (n_iter, 64, 2048) float32 buffer reaches 4 GB at n_iter = 8192
    z_store = dict(store=("means", "lams", "Z"), n_chains=128)
    return [
        ("random_walk", y, prior, {}, "fused_mixture"),
        ("conjugate", y, prior, dict(conjugate=True), "fused_mixture_conjugate"),
        ("no_box", y, prior, dict(domain=False), "fused_mixture"),
        ("weak_a0", y, prior, dict(a0=0.5), None),
        ("store_z", y, prior, dict(store=("Z", "means", "lams")), "fused_mixture"),
        ("z_at_cap", y, prior, dict(n_iter=8192, **z_store), "fused_mixture"),
        ("z_past_cap", y, prior, dict(n_iter=8193, **z_store), None),
        ("streamed_n", y3000, prior3000, {}, "fused_mixture"),
        ("replicates", np.concatenate([y, y + 0.1], axis=1)[:40], prior[:40], {}, "fused_mixture"),
        ("k_past_max", y_big_k, prior_big_k, {}, None),
        ("start_on_box", y, prior, dict(means=np.array([[-20.0], [0.0], [1.0]])), None),
        ("thinned", y, prior, dict(n_thin=3, conjugate=True), "fused_mixture_conjugate"),
    ]


def test_dispatch_matches_jax():
    """(h) match_fused_engine in both packages picks the same engine or none on
    every case, with the same store keys; an extra model term falls back; the
    port's runner returns the JAX shapes and statistics, and malformed kernel
    inputs raise."""
    from openmcmc_tpu.fused.dispatch import match_fused_engine as jmatch
    from openmcmc_tpu_torch.fused.dispatch import match_fused_engine as tmatch

    for name, y, prior, kw, want in _dispatch_cases():
        j, t = (match(build(pkg, y, prior, **kw)) for match, pkg in ((jmatch, PKGS[0]), (tmatch, PKGS[1])))
        assert getattr(j, "engine_name", None) == getattr(t, "engine_name", None) == want, name
        if t is not None:
            assert t.store_keys == j.store_keys, name

    y, prior = mixture_data(np.random.default_rng(8), 60, 3)
    for pkg, match in zip(PKGS, (jmatch, tmatch)):
        m = build(pkg, y, prior)
        dist = importlib.import_module(f"{pkg}.distributions")
        m.model = type(m.model)(list(m.model.values()) + [dist.Normal("extra", mean="mu0", precision="P0")])
        assert match(m) is None, pkg

    res = build("openmcmc_tpu_torch", y, prior, store=("Z", "means", "lams")).run(engine="auto")
    assert res.engine == "fused_mixture" and res.store["Z"].shape == (8, 4, 60, 1)
    assert res.store["Z"].dtype == torch.int32 and res.final_state["Z"].shape == (8, 60, 1)
    assert res.store["means"].shape == res.store["lams"].shape == (8, 4, 3, 1)
    assert set(res.stats) == {"Z", "means", "lams"} and res.stats["means"]["proposal"].tolist() == [6] * 8
    res = build("openmcmc_tpu_torch", y, prior, conjugate=True).run(engine="auto")
    assert res.engine == "fused_mixture_conjugate" and res.stats["means"] == {} and set(res.store) == {"means", "lams"}

    scal, data, kw = tmix.prepare(y, prior, 0.0, 0.01, 2.0, 1.0, np.zeros(3), np.ones(3), device="cpu")
    assert kw == dict(k_comp=3, n=60, threads=32, has_domain=False) and data.shape == (6, 60)
    with pytest.raises(ValueError, match="a0 >= 1"):
        tmix.prepare(y, prior, 0.0, 0.01, 0.5, 1.0, np.zeros(3), np.ones(3), device="cpu")
    with pytest.raises(ValueError, match="threads"):
        tmix.mixture_sweeps(0, scal, data, 4, k_comp=3, n=60, threads=48, conjugate=True, has_domain=False, step=0.2,
                            n_burn=0, n_keep=1)
    with pytest.raises(NotImplementedError, match="operations"):
        tmix.run_fused_mixture(0, y, prior, 0, 1, 4, 0.0, 0.01, 2.0, 1.0, np.zeros(3), np.ones(3), init={},
                               device="cpu")
    assert [tmix.block_threads(n) for n in (1, 30, 200, 1000, 3000, 100_000)] == [32, 32, 64, 256, 256, 256]


def _sorted_moments(res):
    """Mean, sd and multi-chain ESS of the sorted means and the lams sorted by
    their means (label switching), per component."""
    means, lams = (torch.as_tensor(np.array(res.store[name])[..., 0], dtype=torch.float64) for name in ("means", "lams"))
    order = torch.argsort(means, dim=-1)
    draws = torch.cat([torch.gather(means, -1, order), torch.gather(lams, -1, order)], dim=-1)
    return draws.mean((0, 1)), draws.std((0, 1)), ess_per_param(draws.float()).double()


def test_slice_matches_jax_generic():
    """(i) bench_all.py's conjugate mixture at 200 points and 32 chains (40 + 60
    sweeps) through the port's MCMC.run(engine="auto") (the fused plain
    version) and MCMC.run() (the generic driver), against the JAX generic run:
    the posterior means of the sorted component means and their lams within 5
    Monte Carlo sd, the sd from each run's multi-chain ESS."""
    rng = np.random.default_rng(0)
    alloc = rng.integers(0, 2, 200)
    y = rng.normal(np.array([-2.0, 3.0])[alloc], 1.0 / np.sqrt(np.array([4.0, 1.0])[alloc]))[:, None]
    prior = np.full((200, 2), 0.5)
    kw = dict(conjugate=True, n_burn=40, n_iter=60, n_chains=32, means=np.array([[-1.0], [1.0]]))
    ref = _sorted_moments(build("openmcmc_tpu", y, prior, seed=1, **kw).run())
    for engine in ("auto", "generic"):
        res = build("openmcmc_tpu_torch", y, prior, seed=2, **kw).run(engine=engine)
        assert res.engine == ("fused_mixture_conjugate" if engine == "auto" else "generic")
        m1, s1, e1 = _sorted_moments(res)
        z = torch.abs(m1 - ref[0]) / torch.sqrt(s1 * s1 / e1 + ref[1] ** 2 / ref[2])
        assert float(z.max()) < 5.0, (engine, z)
