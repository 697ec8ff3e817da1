"""The port's reversible jump against the JAX package's: padding and the
Gaussian-kernel basis, the masked priors, the matched birth and death
transitions, kernel K11's plain version (``fused/rj.py``) against the JAX kernel
in interpret mode, its log_post against ``Model.log_p``, the dispatch, and the
whole slice through ``MCMC.run``.

The JAX engine runs its Pallas kernel in interpret mode with a host bit source
(see tests/test_torch_spectral.py); the port's plain version takes the same bits
(:func:`rj_bits`: the port numbers its draw sites in the JAX kernel's order, so
site k of a sweep is the JAX kernel's k-th draw) and must reproduce every stored
count, counter and accept, and the draws within rtol 1e-4. The two JAX runs are
made once per module (:func:`jax_k11`) and shared by the tests that read them.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from scipy.stats import poisson

from openmcmc_tpu.fused import prng as jprng
from openmcmc_tpu.fused import rj as jrj
from openmcmc_tpu_torch.diagnostics import ess_per_param
from openmcmc_tpu_torch.fused import rj as trj

torch.set_num_threads(2)

PKGS = ("openmcmc_tpu", "openmcmc_tpu_torch")
LIMITS = (-10.0, 10.0)


def _mods(pkg):
    names = ("basis", "distributions", "parameters", "samplers", "model", "mcmc", "linalg.structured", "padding")
    return [importlib.import_module(f"{pkg}.{m}") for m in names]


def rj_mcmc(pkg, n_max=6, n_chains=16, n_burn=2, n_iter=4, lik=False, seed=0, store=("n_basis",), n_data=50,
            basis=None, **state_over):
    """bench_all.py's ``reversible_jump`` (Null likelihood) or
    ``reversible_jump_regression`` (y ~ N(B beta, (tau_y I)^-1) and a fifth
    sampler NormalGamma(tau_y)) in either package, at a given n_max."""
    bmod, dist, par, smp, model, mcmc, st, _ = _mods(pkg)
    g = basis if basis is not None else bmod.GaussianKernelBasis()
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(-10, 10, (n_data, 1)), axis=0)
    if lik:
        th_true, beta_true = rng.uniform(-10, 10, (1, 4)), 2.0 * rng.normal(size=(4, 1))
        y = np.exp(-0.5 * (X - th_true) ** 2) / np.sqrt(2 * np.pi) @ beta_true + 0.1 * rng.normal(size=(n_data, 1))
    else:
        y = rng.normal(size=(n_data, 1))
    k0 = min(4, n_max)
    theta = np.zeros((1, n_max)); theta[0, :k0] = rng.uniform(-10, 10, k0)
    omega = np.zeros((1, n_max)); omega[0, :k0] = 1.0
    beta = np.zeros((n_max, 1)); beta[:k0] = 1.0
    ones = jnp.ones(n_data) if pkg == PKGS[0] else torch.ones(n_data)
    state = {"X": X, "y": y, "n_basis": np.array([[k0]], dtype=np.int32), "theta": theta, "omega": omega,
             "beta": beta, "alloc_beta": np.zeros((n_max, 1), dtype=np.int32), "mu_beta": 0.0, "tau_beta": 0.25,
             "rho": 8.0, "a_omega": 3.0, "b_omega": 2.0, "P": st.Diagonal(ones), "tau_y": 100.0}
    if lik:
        state.update(a_tau=2.0, b_tau=0.01)
    state.update(state_over)
    om_safe = np.where(omega > 0, omega, 1.0)  # the initial basis, in float64 on the host for both packages
    state["B"] = np.exp(-0.5 * ((X - theta) / om_safe) ** 2) / (om_safe * np.sqrt(2 * np.pi)) * (np.arange(n_max) < k0)
    likelihood = dist.Normal if lik else dist.NullDistribution
    dists = [
        likelihood("y", mean=par.LinearCombination(form={"beta": "B"}), precision=par.ScaledMatrix("P", "tau_y")),
        dist.Normal("beta", mean=par.MixtureParameterVector("mu_beta", "alloc_beta"),
                    precision=par.MixtureParameterMatrix("tau_beta", "alloc_beta"), n_active="n_basis"),
        dist.Poisson("n_basis", rate="rho"),
        dist.Uniform("theta", domain_response_lower=LIMITS[0], domain_response_upper=LIMITS[1], n_active="n_basis"),
        dist.Gamma("omega", shape="a_omega", rate="b_omega", n_active="n_basis"),
    ] + ([dist.Gamma("tau_y", shape="a_tau", rate="b_tau")] if lik else [])
    mdl = model.Model(dists)
    walk = dict(state_update_function=g.move, vector_state_update_function=g.move_vec, active_count="n_basis")
    samplers = [
        smp.ManifoldMALA("beta", mdl, step=0.5, active_count="n_basis"),
        smp.RandomWalkLoop("theta", mdl, step=0.1, domain_limits=np.asarray([LIMITS]), updated_names=["theta", "B"],
                           **walk),
        smp.RandomWalkLoop("omega", mdl, step=0.1, domain_limits=np.asarray([[0.5, 2.0]]),
                           updated_names=["omega", "B"], **walk),
        smp.ReversibleJump("n_basis", mdl, associated_params=["theta", "omega"], n_max=n_max,
                           state_birth_function=g.birth, state_death_function=g.death,
                           matching_params={"variable": "beta", "matrix": "B", "scale": 1.0, "limits": list(LIMITS)}),
    ] + ([smp.NormalGamma("tau_y", mdl)] if lik else [])
    kw = {"device": "cpu"} if pkg == PKGS[1] else {}
    return mcmc.MCMC(state, samplers, mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains, seed=seed,
                     store_names=list(store), **kw)


# ---------------------------------------------------------------------------
# padding, the basis and the masked priors
# ---------------------------------------------------------------------------


def test_padding_and_basis_match_jax():
    """(a) padding's seven helpers per chain (3 chains, n_max 8, each its own
    count and index) equal the JAX package's vmapped ones exactly; the basis
    (the JAX package's norm.pdf order) within 1e-6 relative, the gap between
    XLA's and torch's float32 exp and log (a few ulp)."""
    from openmcmc_tpu import basis as jb, padding as jp
    from openmcmc_tpu_torch import basis as tb, padding as tp

    rng = np.random.default_rng(0)
    arr = rng.normal(size=(3, 1, 8)).astype(np.float32)
    cnt, idx = np.array([2, 5, 8]), np.array([0, 3, 7])
    val = rng.normal(size=(3, 1, 1)).astype(np.float32)
    mat = rng.normal(size=(3, 8, 8)).astype(np.float32)
    col = rng.normal(size=(3, 8, 1)).astype(np.float32)
    X = np.sort(rng.uniform(-10, 10, (12, 1)), axis=0).astype(np.float32)
    th = np.zeros((3, 1, 8), np.float32); th[:, 0, :5] = rng.uniform(-10, 10, (3, 5))
    om = np.zeros((3, 1, 8), np.float32); om[:, 0, :5] = rng.uniform(0.5, 2.0, (3, 5))
    g_j, g_t = jb.GaussianKernelBasis(), tb.GaussianKernelBasis()

    def reference(a, v, c, i, mt, cl, t, o):  # every JAX helper on one chain; vmapped and compiled once
        return {"append": jp.append(a, v, c, axis=1), "delete": jp.delete(a, i, c, axis=1),
                "take_column": jp.take_column(a, i, axis=1), "take_column_rows": jp.take_column(cl, i, axis=0),
                "mask_along_axis": jp.mask_along_axis(a, c, axis=1), "insert_column": jp.insert_column(mt, cl, i),
                "insert_identity_column": jp.insert_identity_column(mt, i),
                "active_mask": jp.active_mask(c, 8, jnp.float32), "basis": g_j.make(jnp.asarray(X), t, o, c)}

    want = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(reference))(arr, val, cnt, idx, mat, col, th, om))
    T = torch.tensor
    got = {"append": tp.append(T(arr), T(val), T(cnt), axis=1), "delete": tp.delete(T(arr), T(idx), T(cnt), axis=1),
           "take_column": tp.take_column(T(arr), T(idx), axis=1),
           "take_column_rows": tp.take_column(T(col), T(idx), axis=0),
           "mask_along_axis": tp.mask_along_axis(T(arr), T(cnt), axis=1),
           "insert_column": tp.insert_column(T(mat), T(col), T(idx)),
           "insert_identity_column": tp.insert_identity_column(T(mat), T(idx)),
           "active_mask": tp.active_mask(T(cnt).reshape(3, 1, 1), 8, torch.float32)}
    for name, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[name], err_msg=name)
    # an index past the axis (a birth at n_max, selected away) gives zero, as the one-hot reduction does
    assert float(tp.take_column(T(arr), T(np.array([8, 8, 8])), axis=1).abs().sum()) == 0.0

    want = want["basis"]
    got = g_t.make(T(X), T(th), T(om), T(cnt).reshape(3, 1, 1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert np.all(got[0, :, 2:] == 0.0) and np.all(got[1, :, 5:] == 0.0)
    # the hooks: move rebuilds one column, move_vec and birth the whole basis
    state = {"X": T(X), "theta": T(th), "omega": T(om), "n_basis": T(cnt).reshape(3, 1, 1),
             "B": T(np.zeros((3, 12, 8), np.float32))}
    moved, lf, lr = g_t.move(None, {}, state, 1)
    assert lf == lr == 0.0
    np.testing.assert_array_equal(moved["B"][:, :, 1].numpy(), got[:, :, 1])
    assert float(moved["B"][:, :, [0, 2]].abs().sum()) == 0.0
    np.testing.assert_array_equal(g_t.move_vec(None, {}, state)["B"].numpy(), got)
    np.testing.assert_array_equal(g_t.birth(None, state, state)[0]["B"].numpy(), got)


def test_masked_distributions_match_jax():
    """(b) The masked log-densities as tests/test_rj.py::test_masked_distributions
    builds them (Normal, Gamma and Uniform with n_active, Poisson,
    NullDistribution), per chain and per observation, within rtol 1e-6 of the
    JAX package's vmapped ones; the masked Normal's gradient and Hessian too."""
    rng = np.random.default_rng(1)
    chains, n_max = 3, 8
    counts = np.array([2, 4, 8], np.int32)
    theta = rng.uniform(-10, 10, (chains, 1, n_max))
    omega = rng.uniform(0.5, 2.0, (chains, 1, n_max))
    beta = rng.normal(size=(chains, n_max, 1))
    per_chain = {"theta": theta, "omega": omega, "beta": beta, "n_basis": counts.reshape(chains, 1, 1)}
    for c, k in enumerate(counts):  # padding entries are zero, as in the padded state
        theta[c, 0, k:] = omega[c, 0, k:] = beta[c, k:, 0] = 0.0
    out = {}
    for pkg in PKGS:
        m = rj_mcmc(pkg, n_max=n_max, rho=3.0)
        mdl = m.model
        names = ("y", "beta", "n_basis", "theta", "omega")
        if pkg == PKGS[0]:
            data = {k: jnp.asarray(v) if not hasattr(v, "diag_") else v for k, v in m.data.items()}

            def per(chain):
                s = {**data, **{k: jnp.asarray(v) for k, v in chain.items()}}
                res = {f"{n}{o}": mdl[n].log_p(s, by_observation=o) for n in names for o in (False, True)}
                res["grad"], res["hess"] = mdl["beta"].grad_log_p(s, "beta")
                return res

            out[pkg] = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(per))(per_chain))
        else:
            s = dict(m.data)
            s.update({k: torch.tensor(v) if v.dtype == np.int32 else torch.tensor(v, dtype=torch.float32)
                      for k, v in per_chain.items()})
            res = {f"{n}{o}": mdl[n].log_p(s, by_observation=o) for n in names for o in (False, True)}
            res["grad"], res["hess"] = mdl["beta"].grad_log_p(s, "beta")
            out[pkg] = {k: torch.broadcast_to(v, (chains,) + tuple(v.shape[1:]) if v.dim() else (chains,)).numpy()
                        for k, v in res.items()}
    for name, want in out[PKGS[0]].items():
        got = out[PKGS[1]][name]
        np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-6, atol=1e-6, err_msg=name)
    assert np.all(out[PKGS[1]]["yTrue"] == 0.0)
    assert np.all(out[PKGS[1]]["grad"][0, 2:] == 0.0)
    np.testing.assert_array_equal(out[PKGS[1]]["hess"][0, 2:, 2:], np.eye(n_max - 2))


def _birth_prop(pkg, state, new_knot, k=4):
    """The proposed state of a birth at ``new_knot`` (omega 1) from ``k`` active
    knots, padded, as tests/test_rj.py builds it."""
    _, _, _, _, _, _, _, pad = _mods(pkg)
    g = _mods(pkg)[0].GaussianKernelBasis()
    prop = dict(state)
    prop["n_basis"] = state["n_basis"] + 1
    if pkg == PKGS[0]:
        new = (jnp.asarray([[new_knot]], state["theta"].dtype), jnp.asarray([[1.0]], state["theta"].dtype))
    else:
        new = (torch.tensor([[new_knot]], dtype=state["theta"].dtype), torch.tensor([[1.0]], dtype=state["theta"].dtype))
    prop["theta"] = pad.append(state["theta"], new[0], k, axis=1)
    prop["omega"] = pad.append(state["omega"], new[1], k, axis=1)
    prop["B"] = g.make(prop["X"], prop["theta"], prop["omega"], prop["n_basis"])
    return prop


def _death_prop(pkg, state, index, k=4):
    """The proposed state of the death of knot ``index`` of ``k``."""
    _, _, _, _, _, _, _, pad = _mods(pkg)
    g = _mods(pkg)[0].GaussianKernelBasis()
    prop = dict(state)
    prop["n_basis"] = state["n_basis"] - 1
    prop["theta"] = pad.delete(state["theta"], index, k, axis=1)
    prop["omega"] = pad.delete(state["omega"], index, k, axis=1)
    prop["B"] = g.make(prop["X"], prop["theta"], prop["omega"], prop["n_basis"])
    return prop


# tests/test_rj.py:173-247: (move, theta of the 4 active knots, beta, new knot or deleted index, proposal scale)
MATCHED = {
    "birth_overlap": ("birth", [-10.0, -5.0, 5.0, 10.0], [1.0] * 4, 10.0, 1e-6),
    "birth_no_overlap": ("birth", [-10.0, -5.0, 5.0, 10.0], [1.0] * 4, 0.0, 1e-6),
    "death_overlap": ("death", [-10.0, -5.0, 10.0, 10.0], [1.0] * 4, 3, 1.0),
    "death_no_overlap": ("death", [-10.0, -5.0, 5.0, 10.0], [1.0, 1.0, 1.0, 0.0], 3, 1.0),
}


@functools.lru_cache(maxsize=None)
def _matched_jax_fn(move, scale):
    """The JAX package's matched ``move`` at proposal ``scale`` as a function of
    (theta, omega, beta, new knot or deleted index), compiled once."""
    m = rj_mcmc(PKGS[0], n_max=8, n_chains=1)
    rj = m.samplers[3]
    rj.matching_params = dict(rj.matching_params, scale=scale)
    g = rj.state_birth_function.__self__
    X = np.asarray(m.data["X"])

    def fn(th, om, be, arg):
        state = dict(m.data)
        state.update(X=jnp.asarray(X, jnp.float64), theta=th, omega=om, beta=be, n_basis=jnp.asarray([[4]], jnp.int32))
        state["B"] = g.make(state["X"], th, om, 4)
        key = jax.random.PRNGKey(0)
        if move == "birth":
            new, fwd, rev = rj.matched_birth_transition(key, state, _birth_prop(PKGS[0], state, arg), 0.0, 0.0)
        else:
            index = arg.astype(jnp.int32)
            new, fwd, rev = rj.matched_death_transition(key, state, _death_prop(PKGS[0], state, index), 0.0, 0.0, index)
        return new["beta"], fwd, rev

    return jax.jit(fn)


def _matched_jax(move, knots, coefs, arg, scale):
    """The JAX package's matched transition of one MATCHED case in float64;
    returns (coefficients, fwd, rev)."""
    with jax.enable_x64(True):
        args = [jnp.asarray(v, jnp.float64) for v in _matched_state(knots, coefs) + (float(arg),)]
        out = _matched_jax_fn(move, scale)(*args)
        return tuple(np.asarray(v, np.float64).reshape(-1) for v in out)


def _matched_state(knots, coefs, n_max=8):
    th = np.zeros((1, n_max)); th[0, :4] = knots
    om = np.zeros((1, n_max)); om[0, :4] = 1.0
    be = np.zeros((n_max, 1)); be[:4, 0] = coefs
    return th, om, be


@pytest.mark.parametrize("case", list(MATCHED))
def test_matched_transitions_match_jax(case):
    """(c) The matched birth and death transitions on the same proposed state
    (n_max 8, 4 active knots, 50 points) in both packages, in float64: the
    proposed coefficients (mu* with the new coefficient, drawn at a proposal
    scale of 1e-6 so that the draw is its mean; or mu_aug after the delete),
    log|det F| and a death's reverse density, within rtol 1e-4. The port factors
    with torch.linalg (Cholesky, LU), the JAX package with its unrolled
    smallmat. Float64 because the overlap cases are singular up to the 1e-6
    ridge: in float32 the split of the duplicated coefficient is fixed only to
    about 1e-2, and two correct factorizations part by 5e-3 there."""
    from openmcmc_tpu_torch.linalg.gmrf import Key

    move, knots, coefs, arg, scale = MATCHED[case]
    bj, fj, rj_ = _matched_jax(move, knots, coefs, arg, scale)
    m = rj_mcmc(PKGS[1], n_max=8, n_chains=1)
    rj = m.samplers[3]
    rj.matching_params = dict(rj.matching_params, scale=scale)
    g = rj.state_birth_function.__self__
    f64 = dict(dtype=torch.float64)
    th, om, be = (torch.tensor(v, **f64)[None] for v in _matched_state(knots, coefs))
    state = dict(m.data)
    state.update(X=m.data["X"].to(torch.float64), theta=th, omega=om, beta=be,
                 n_basis=torch.tensor([[[4]]], dtype=torch.int32))
    state["B"] = g.make(state["X"], th, om, state["n_basis"])
    key = Key(torch.Generator().manual_seed(0))
    if move == "birth":
        new, fwd, rev = rj.matched_birth_transition(key, state, _birth_prop(PKGS[1], state, arg), 0.0, 0.0)
    else:
        new, fwd, rev = rj.matched_death_transition(key, state, _death_prop(PKGS[1], state, arg), 0.0, 0.0,
                                                    torch.tensor([arg]))
    assert new["beta"].dtype == torch.float64
    bt = new["beta"].reshape(-1).numpy()
    np.testing.assert_allclose(bt, bj, rtol=1e-4, atol=1e-4)
    # birth: rev is log|det F| (fwd the density of the random draw); death: fwd is
    # log|det F|, rev the deleted coefficient's density under the proposal
    got, want = [float(rev[0])], [rj_[0]]
    if move == "death":
        got, want = got + [float(fwd[0])], want + [fj[0]]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if case == "birth_no_overlap":
        assert abs(bt[4]) < 1e-3 and abs(float(rev[0])) < 1e-3


def rj_bits(seed, chains):
    """The bits the interpret-mode JAX kernel draws in grid program 0 under a
    host bit source, as a port bit source ``(sweep, site, (chains, width))``: the
    JAX kernel folds the sweep into its key and numbers its draws, and the port's
    site k is its k-th draw, element j its row j."""
    base = jax.random.PRNGKey(seed)
    draw = jax.jit(lambda it, site, rows: jax.random.bits(jax.random.fold_in(jax.random.fold_in(base, it), site),
                                                          (rows, jrj.BLOCK_B), jnp.uint32), static_argnums=2)

    def source(it, site, shape):
        c, w = shape
        return torch.from_numpy(np.asarray(draw(it, site, w))[:w, :c].T.astype(np.int64))

    return source


# (likelihood, n_burn, n_iter, n_thin): the smallest runs that still reach a
# birth, a death and a rejected move of each kind on some chain
K11_CASES = {"null": (False, 0, 1, 2), "likelihood": (True, 0, 2, 1)}


def k11_kwargs(lik, n_burn, n_iter, n_thin):
    """16 chains, n_max 4, 8 points, rho 2, two of four knots active, mMALA
    step 1.5 (so that some beta moves are rejected)."""
    rng = np.random.default_rng(1)
    X = np.sort(rng.uniform(-10, 10, 8))
    th = np.zeros(4); th[:2] = rng.uniform(-10, 10, 2)
    om = np.zeros(4); om[:2] = 1.0
    be = np.zeros(4); be[:2] = 1.0
    kw = dict(n_burn=n_burn, n_iter=n_iter, n_chains=16, n_max=4, beta0=be, theta0=th, omega0=om, k0=2, rho=2.0,
              step_mmala=1.5, stream_params=True, n_thin=n_thin)
    if lik:
        kw.update(y=np.sin(X) + 0.1 * rng.normal(size=8), a_tau=2.0, b_tau=0.1, tau0=1.0)
    return X, kw


@pytest.fixture(scope="module")
def jax_k11():
    """One JAX interpret-mode run per K11 case, with its inputs, made on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            X, kw = k11_kwargs(*K11_CASES[case])
            jax.clear_caches()
            with pltpu.force_tpu_interpret_mode(), jprng.host_bits(jprng.HostBitSource()):
                want = {name: np.asarray(v) for name, v in jrj.run_fused_rj(5, X, **kw).items()}
            jax.clear_caches()
            cache[case] = (X, kw, want)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(K11_CASES))
def test_k11_plain_matches_jax(jax_k11, case):
    """(d) K11's plain version against the JAX kernel in interpret mode on its
    host bits, both variants (the Null one thinned by 2), parameters streamed:
    every stored count, counter and accept equal; beta, theta, omega, tau and
    log_post within rtol 1e-4, atol 1e-5. The runs reach births, deaths and
    rejected moves of every kind."""
    X, kw, want = jax_k11(case)
    got = {k: v.numpy() if torch.is_tensor(v) else v
           for k, v in trj.run_fused_rj(5, X, **kw, device="cpu", bit_source=rj_bits(5, 16)).items()}
    assert set(got) == set(want)
    exact = ("n_basis", "accept_mmala", "accept_theta", "accept_omega", "accept_rj", "proposal_theta",
             "proposal_omega", "n_proposals")
    for name in exact:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in set(want) - set(exact):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-5, err_msg=name)
    k = np.concatenate([np.full((16, 1), 2.0), got["n_basis"]], axis=1)
    n_sweeps = got["n_proposals"]
    assert np.any(np.diff(k) > 0) and np.any(np.diff(k) < 0), k  # a birth and a death
    assert np.any(got["accept_rj"] < n_sweeps) and np.any(got["accept_mmala"] < n_sweeps)
    assert np.any(got["accept_theta"] < got["proposal_theta"]) and np.any(got["accept_omega"] < got["proposal_omega"])


@pytest.mark.parametrize("lik", [False, True], ids=["null", "likelihood"])
def test_k11_log_post_matches_model(lik):
    """(e) The plain version's stored log_post equals the port's Model.log_p at
    the stored (n_basis, beta, theta, omega, tau_y) with B rebuilt from them,
    within 1e-4 relative, for both variants (n_max 6, 50 points)."""
    m = rj_mcmc(PKGS[1], n_chains=4, n_burn=3, n_iter=3, lik=lik,
                store=("n_basis", "beta", "theta", "omega") + (("tau_y",) if lik else ()))
    res = m.run(engine="auto")
    assert res.engine == "fused_rj"
    g = m.samplers[3].state_birth_function.__self__
    for c in range(4):
        for t in range(3):
            state = dict(m.data)
            state.update({name: v[c, t] for name, v in res.store.items()})
            state["B"] = g.make(state["X"], state["theta"], state["omega"], state["n_basis"])
            want = float(m.model.log_p(state))
            assert abs(float(res.log_post[c, t]) - want) <= 1e-4 * max(1.0, abs(want)), (lik, c, t, want)


def _dispatch_cases():
    """(name, model keywords, edit of the built MCMC, engine): the routes of
    tests/test_fused_rj_engine.py and the streamed-draw cap's boundary (64 chains
    pad to the JAX engine's 1024 lanes; 68 rows at n_max 20 reach 4 GB past
    n_iter 15420)."""
    def set_attr(i, name, value):
        return lambda m: setattr(m.samplers[i], name, value)

    def store(*names):
        return lambda m: setattr(m, "store_names", list(names))

    def opaque_birth(m):
        g = m.samplers[3].state_birth_function

        def birth(key, cur, prop):  # the same math, but opaque to the matcher
            return g(key, cur, prop)

        m.samplers[3].state_birth_function = birth

    def fitted(m):
        m.model.response = {"y": "mean"}

    streamed = ("n_basis", "beta", "theta", "omega")
    return [
        ("null", {}, None, "fused_rj"),
        ("likelihood", dict(lik=True), None, "fused_rj"),
        ("opaque_hooks", {}, opaque_birth, None),
        ("store_theta", {}, store("n_basis", "theta"), "fused_rj"),
        ("store_basis", {}, store("n_basis", "B"), None),
        ("stream_at_cap", dict(n_max=20, n_chains=64, n_iter=15420, store=streamed), None, "fused_rj"),
        ("stream_past_cap", dict(n_max=20, n_chains=64, n_iter=15421, store=streamed), None, None),
        ("rw_limits", {}, set_attr(1, "domain_limits", np.asarray([[-9.0, 10.0]])), None),
        ("penalty", dict(lik=True, P="two"), None, None),
        ("fitted_on_basis", dict(lik=True), fitted, None),
        ("replicated_y", dict(lik=True, y="two_columns"), None, None),
        ("adapt_step", {}, set_attr(0, "adapt_step", True), None),
        ("n_max_33", dict(n_max=33), None, None),
        ("thinned", {}, lambda m: setattr(m, "n_thin", 3), "fused_rj"),
    ]


def test_dispatch_matches_jax():
    """(f) match_fused_engine in both packages picks the same engine or none on
    every route, with the same store keys; the port's runner returns the JAX
    shapes and statistics, run(resume=...) continues the chains with the
    counters accumulated, and malformed kernel inputs raise."""
    from openmcmc_tpu.fused.dispatch import match_fused_engine as jmatch
    from openmcmc_tpu_torch.fused.dispatch import match_fused_engine as tmatch

    for name, kw, edit, want in _dispatch_cases():
        engines = []
        for pkg, match in zip(PKGS, (jmatch, tmatch)):
            kw2 = dict(kw)
            if kw2.get("P") == "two":
                kw2["P"] = _mods(pkg)[6].Diagonal(jnp.full(50, 2.0) if pkg == PKGS[0] else torch.full((50,), 2.0))
            if kw2.get("y") == "two_columns":
                kw2["y"] = np.random.default_rng(3).normal(size=(50, 2))
            m = rj_mcmc(pkg, **kw2)
            if edit is not None:
                edit(m)
            engines.append(match(m))
        j, t = engines
        assert getattr(j, "engine_name", None) == getattr(t, "engine_name", None) == want, name
        if t is not None:
            assert t.store_keys == j.store_keys, name

    for lik in (False, True):
        m = rj_mcmc(PKGS[1], n_chains=8, n_burn=2, n_iter=3, lik=lik,
                    store=("n_basis", "beta", "theta", "omega") + (("tau_y",) if lik else ()))
        res = m.run(engine="auto")
        assert res.engine == "fused_rj"
        assert res.store["n_basis"].shape == (8, 3, 1, 1) and res.store["n_basis"].dtype == torch.int32
        assert res.store["beta"].shape == (8, 3, 6, 1) and res.store["theta"].shape == (8, 3, 1, 6)
        assert res.final_state["omega"].shape == (8, 1, 6) and res.log_post.shape == (8, 3)
        assert set(res.stats) == {"beta", "theta", "omega", "n_basis"} | ({"tau_y"} if lik else set())
        for name in ("beta", "theta", "omega", "n_basis"):
            assert res.stats[name]["accept"].dtype == res.stats[name]["proposal"].dtype == torch.int32
            assert res.stats[name]["accept"].shape == (8,)
        assert res.stats["beta"]["proposal"].tolist() == [5] * 8
        assert set(res.acceptance) == {"beta", "theta", "omega", "n_basis"}
        if lik:
            assert res.stats["tau_y"] == {} and res.store["tau_y"].shape == (8, 3, 1, 1)
    resumed = m.run(engine="auto", resume=res)
    assert resumed.engine == "fused_rj" and resumed.stats["beta"]["proposal"].tolist() == [8] * 8
    config = trj.make_config(4, 8, n_chains=2)
    with pytest.raises(ValueError, match="init"):
        trj.rj_sweeps(torch.zeros(8), torch.zeros((2, 5)), 2, config=config)
    with pytest.raises(ValueError, match="n_max"):
        trj.make_config(33, 8)


def _k_moments(res):
    """Posterior mean, sd and multi-chain ESS of the stored count."""
    k = res.store["n_basis"][..., 0, 0].to(torch.float32)
    return float(k.double().mean()), float(k.double().std()), float(ess_per_param(k[..., None])[0])


def test_slice_recovers_the_prior_and_matches_generic():
    """(g) bench_all.py's reversible jump at n_max 6 (48 chains, 10 + 90 sweeps)
    through the port's MCMC.run(engine="auto") (the fused plain version) and
    MCMC.run() (the generic driver): the count marginal of each run matches the
    [1, 6]-truncated Poisson(8) in mean within 5 Monte Carlo sd (each run's own
    multi-chain ESS). The regression (32 chains, 20 + 80 sweeps): the fused and
    generic posterior means of the count and of tau_y agree within 5 MC sd."""
    ks = np.arange(1, 7)
    pmf = poisson.pmf(ks, 8.0) / poisson.pmf(ks, 8.0).sum()
    exact_mean = float((ks * pmf).sum())
    exact_sd = float(np.sqrt((ks * ks * pmf).sum() - exact_mean ** 2))
    for engine in ("auto", "generic"):
        res = rj_mcmc(PKGS[1], n_chains=48, n_burn=10, n_iter=90, seed=3).run(engine=engine)
        assert res.engine == ("fused_rj" if engine == "auto" else "generic")
        mean, _, ess = _k_moments(res)
        assert abs(mean - exact_mean) < 5.0 * exact_sd / np.sqrt(ess), (engine, mean, exact_mean, ess)

    runs = {}
    for engine in ("auto", "generic"):
        res = rj_mcmc(PKGS[1], n_chains=32, n_burn=20, n_iter=80, lik=True, seed=4,
                      store=("n_basis", "tau_y")).run(engine=engine)
        tau = res.store["tau_y"][..., 0]
        runs[engine] = (_k_moments(res), (float(tau.double().mean()), float(tau.double().std()),
                                         float(ess_per_param(tau)[0])))
    for (m1, s1, e1), (m2, s2, e2) in zip(runs["auto"], runs["generic"]):
        assert abs(m1 - m2) < 5.0 * np.sqrt(s1 * s1 / e1 + s2 * s2 / e2), runs
