"""The port's Metropolis family against the JAX package's: the truncated-normal
densities, the distributions' and the model's gradients and negative Hessians on
chain-batched states, the generic RandomWalk, RandomWalkLoop and ManifoldMALA
runs against the JAX generic runs and the analytic posteriors, the statistics
they return, and the driver's carried-log-density decisions.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmcmc_tpu.fused import prng as jprng
from openmcmc_tpu.linalg import gmrf as jgmrf
from openmcmc_tpu_torch.diagnostics import ess_per_param
from openmcmc_tpu_torch.fused import prng as tprng
from openmcmc_tpu_torch.linalg import gmrf as tgmrf

torch.set_num_threads(2)


def test_truncated_densities_match_jax():
    """(a) gmrf.truncated_normal_log_pdf (log_ndtr form) and the kernels'
    truncnorm_logpdf (polynomial erf) equal the JAX functions within float32
    rounding, including points outside the box (-inf), boxes open on one side,
    and a box deep in one tail (the survival form)."""
    rng = np.random.default_rng(0)
    n = 400
    mean = rng.normal(size=n).astype(np.float32)
    scale = rng.uniform(0.2, 2.0, n).astype(np.float32)
    lo = (mean - rng.uniform(0.0, 3.0, n)).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 4.0, n)).astype(np.float32)
    x = (lo + (hi - lo) * rng.uniform(-0.2, 1.2, n)).astype(np.float32)
    lo[::9], hi[::11] = -np.inf, np.inf
    lo[5::13], hi[5::13], x[5::13] = mean[5::13] + 6.0, mean[5::13] + 9.0, mean[5::13] + 7.0
    for lower, upper in ((lo, hi), (None, hi), (lo, None)):
        want = np.asarray(jgmrf.truncated_normal_log_pdf(x, mean, scale, lower=lower, upper=upper))
        got = tgmrf.truncated_normal_log_pdf(*(torch.from_numpy(v) for v in (x, mean, scale)),
                                             lower=None if lower is None else torch.from_numpy(lower),
                                             upper=None if upper is None else torch.from_numpy(upper)).numpy()
        assert np.array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=2e-5, atol=2e-5)

    lo_k, hi_k = np.where(np.isfinite(lo), lo, -1e30), np.where(np.isfinite(hi), hi, 1e30)
    want = np.asarray(jax.jit(jprng.truncnorm_logpdf)(x, mean, scale, lo_k, hi_k))
    got = tprng.truncnorm_logpdf(*(torch.from_numpy(np.asarray(v, np.float32)) for v in (x, mean, scale, lo_k, hi_k)))
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-5, atol=1e-5)


def _jax_state(state, chain):
    """One chain's JAX state from a port state: per-chain tensors sliced."""
    from openmcmc_tpu.linalg import structured as jst
    from openmcmc_tpu_torch.linalg import structured as st

    out = {}
    for k, v in state.items():
        if isinstance(v, st.Diagonal):
            out[k] = jst.Diagonal(jnp.asarray(v.diag_.numpy()))
        elif v.dim() == 3:
            out[k] = jnp.asarray(v[chain].numpy())
        else:
            out[k] = jnp.asarray(v.numpy())
    return out


def _models(pkg):
    dist = importlib.import_module(f"{pkg}.distributions")
    params = importlib.import_module(f"{pkg}.parameters")
    Model = importlib.import_module(f"{pkg}.model").Model
    return Model([
        dist.Normal("y", mean=params.LinearCombination(form={"beta": "X"}), precision=params.ScaledMatrix("P", "tau")),
        dist.Normal("beta", mean="mu", precision=params.ScaledMatrix("P0", "lam")),
        dist.Gamma("tau", shape="a", rate="b"),
    ])


@pytest.fixture(scope="module")
def grad_problem():
    """A linear-Gaussian model with per-chain beta, tau and lam (3 chains, float64
    so the finite differences are meaningful), beta with 2 replicate columns in
    the response case."""
    from openmcmc_tpu_torch.linalg import structured as st

    rng = np.random.default_rng(1)
    C, N, p = 3, 12, 4
    f64 = dict(dtype=torch.float64)
    state = {
        "y": torch.tensor(rng.normal(size=(N, 1)), **f64), "X": torch.tensor(rng.normal(size=(N, p)), **f64),
        "P": st.Diagonal(torch.tensor(rng.uniform(0.5, 2.0, N), **f64)),
        "P0": st.Diagonal(torch.tensor(rng.uniform(0.5, 2.0, p), **f64)),
        "mu": torch.tensor(rng.normal(size=(p, 1)), **f64), "a": torch.full((1, 1), 2.0, **f64),
        "b": torch.full((1, 1), 1.5, **f64), "beta": torch.tensor(rng.normal(size=(C, p, 1)), **f64),
        "tau": torch.tensor(rng.uniform(0.5, 2.0, (C, 1, 1)), **f64),
        "lam": torch.tensor(rng.uniform(0.5, 2.0, (C, 1, 1)), **f64),
    }
    return state, _models("openmcmc_tpu_torch"), _models("openmcmc_tpu")


@pytest.mark.parametrize("case", ["response", "linear_mean", "precision_scalar", "gamma_response", "model"])
def test_gradients_match_jax(grad_problem, case):
    """(b) Normal.grad_log_p with respect to its response (analytic, with the
    Kronecker over 2 replicate columns), a linear mean parameter (analytic), a
    precision scalar (autodiff through log_p, vmapped over chains), Gamma's
    response (autodiff) and Model.grad_log_p equal the JAX package's per chain
    within 1e-6 relative (float64 here, x64 there); the autodiff cases also
    match the finite-difference cross-checks within 1e-4."""
    state, tmodel, jmodel = grad_problem
    state = dict(state)
    if case == "response":
        state["beta"] = torch.cat([state["beta"], 0.5 * state["beta"]], dim=-1)
    dist_name, param = {"response": ("beta", "beta"), "linear_mean": ("y", "beta"),
                        "precision_scalar": ("y", "tau"), "gamma_response": ("tau", "tau"),
                        "model": (None, "beta")}[case]
    port = tmodel if dist_name is None else tmodel[dist_name]
    grad, hess = port.grad_log_p(state, param)
    C, d = state["beta"].shape[0], state[param].shape[-2] * state[param].shape[-1]
    assert grad.shape == state[param].shape and hess.shape[-2:] == (d, d)
    with jax.enable_x64(True):
        ref = jmodel if dist_name is None else jmodel[dist_name]
        for c in range(C):
            g_j, h_j = ref.grad_log_p(_jax_state(state, c), param)
            np.testing.assert_allclose(grad[c].numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-9, err_msg=case)
            h_c = hess[c] if hess.dim() == 3 else hess
            np.testing.assert_allclose(h_c.numpy(), np.asarray(h_j).reshape(d, d), rtol=1e-6, atol=1e-9, err_msg=case)
    if case in ("precision_scalar", "gamma_response"):
        torch.testing.assert_close(grad, port.grad_log_p_diff(state, param), rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(hess, port.hessian_log_p_diff(state, param), rtol=1e-4, atol=1e-3)


def build(pkg, kind, n_chains, n_burn, n_iter, seed, **kw):
    """The generic-driver problems with known posteriors, in either package."""
    dist = importlib.import_module(f"{pkg}.distributions")
    params = importlib.import_module(f"{pkg}.parameters")
    smp = importlib.import_module(f"{pkg}.samplers")
    Model = importlib.import_module(f"{pkg}.model").Model
    MCMC = importlib.import_module(f"{pkg}.mcmc").MCMC
    if kind in ("rw", "rw_truncated"):
        # the reference's example 2
        mdl = Model([dist.Normal("y", mean="h", precision="tau"), dist.Normal("h", mean="mu", precision="lambda")])
        state = {"y": np.array([[150.0, 155.0, 190.0, 160.0, 173.0]]), "h": 175.0, "tau": np.eye(1) / 200.0,
                 "mu": 160.0, "lambda": np.eye(1) / 100.0}
        box = {"domain_limits": [[120.0, 185.0]]} if kind == "rw_truncated" else {}
        sampler = smp.RandomWalk("h", mdl, step=8.0, **box)
    elif kind in ("loop_vectorized", "loop_sequential"):
        # Gamma(3, 2) columns, truncated proposals; the sequential case adds a
        # Normal likelihood on each column, which the vectorized test refuses
        terms = [dist.Gamma("omega", shape="a", rate="b")]
        if kind == "loop_sequential":
            terms.append(dist.Normal("y", mean="omega", precision="tau"))
        mdl = Model(terms)
        state = {"omega": np.full((1, 3), 1.0), "a": 3.0, "b": 2.0, "y": np.array([[1.0, 2.0, 0.5]]),
                 "tau": np.eye(1) * 2.0}
        sampler = smp.RandomWalkLoop("omega", mdl, step=0.6, domain_limits=[[0.05, 8.0]])
    else:
        # the mMALA regression, p = 3
        rng = np.random.default_rng(0)
        X = rng.normal(size=(30, 3))
        y = X @ np.array([1.0, -0.5, 0.3]) + 0.5 * rng.normal(size=30)
        mdl = Model([dist.Normal("y", mean=params.LinearCombination(form={"beta": "X"}), precision="tau"),
                     dist.Normal("beta", mean="mu0", precision="P0")])
        state = {"y": y.reshape(-1, 1), "X": X, "beta": np.zeros((3, 1)), "tau": np.eye(30) * 4.0,
                 "mu0": np.zeros((3, 1)), "P0": np.eye(3) * 0.5}
        sampler = smp.ManifoldMALA("beta", mdl, step=1.0)
    return MCMC(state, [sampler], mdl, n_burn=n_burn, n_iter=n_iter, n_chains=n_chains, seed=seed, **kw)


def analytic(kind):
    """Posterior means and sds of the problems above."""
    if kind in ("rw", "rw_truncated"):
        prec = 5 / 200.0 + 1 / 100.0
        return np.array([(828.0 / 200.0 + 1.6) / prec]), np.array([prec ** -0.5])
    if kind == "loop_vectorized":
        return np.full(3, 1.5), np.full(3, np.sqrt(3.0) / 2.0)
    if kind == "loop_sequential":
        return None  # Gamma prior times a Normal likelihood: no closed form used here
    rng = np.random.default_rng(0)
    X = rng.normal(size=(30, 3))
    y = X @ np.array([1.0, -0.5, 0.3]) + 0.5 * rng.normal(size=30)
    A = 4.0 * X.T @ X + 0.5 * np.eye(3)
    return np.linalg.solve(A, 4.0 * X.T @ y), np.sqrt(np.diag(np.linalg.inv(A)))


def _moments(draws):
    """Mean, sd and multi-chain ESS per coordinate of (chains, n_iter, dims) draws."""
    t = torch.as_tensor(np.asarray(draws, np.float64))
    return t.mean((0, 1)).numpy(), t.std((0, 1)).numpy(), ess_per_param(t.float()).double().numpy()


@pytest.mark.parametrize("kind", ["rw", "rw_truncated", "loop_vectorized", "loop_sequential", "mmala"])
def test_generic_matches_jax_and_analytic(kind):
    """(c) The port's generic driver samples the JAX generic driver's posterior
    (128 chains, 150 burn-in, 200 stored): every posterior mean within 5 Monte
    Carlo sd of the JAX run's and of the analytic mean, the Monte Carlo sd taken
    from each run's multi-chain ESS. The sequential RandomWalkLoop is forced by
    its likelihood, the vectorized one checked to take the vectorized path."""
    name = {"rw": "h", "rw_truncated": "h", "mmala": "beta"}.get(kind, "omega")
    mcmc = build("openmcmc_tpu_torch", kind, 128, 150, 200, seed=1, device="cpu")
    if kind.startswith("loop"):
        assert mcmc.samplers[0]._vectorized_ok() == (kind == "loop_vectorized")
    res = mcmc.run()
    assert res.engine == "generic"
    port = _moments(res.store[name].reshape(128, 200, -1))
    ref = build("openmcmc_tpu", kind, 128, 150, 200, seed=2).run()
    jax_m = _moments(np.asarray(ref.store[name]).reshape(128, 200, -1))
    z = np.abs(port[0] - jax_m[0]) / np.sqrt(port[1] ** 2 / port[2] + jax_m[1] ** 2 / jax_m[2])
    assert np.all(z < 5.0), (kind, port[0], jax_m[0], z)
    exact = analytic(kind)
    if exact is not None:
        z = np.abs(port[0] - exact[0]) / (port[1] / np.sqrt(port[2]))
        assert np.all(z < 5.0), (kind, port[0], exact[0], z)
        np.testing.assert_allclose(port[1], exact[1], rtol=0.1)
    if kind == "rw_truncated":
        assert float(res.store["h"].min()) >= 120.0 and float(res.store["h"].max()) <= 185.0


def test_statistics_and_adaptation():
    """(d) MCMCResult.stats: per-chain int32 accept and proposal counts over
    burn-in and sampling (RandomWalkLoop: one proposal per column), the carried
    logp of a single sampler, and an adapted log_step in the step's shape that
    moved a far-too-large step toward the target acceptance."""
    mcmc = build("openmcmc_tpu_torch", "rw", 64, 40, 60, seed=3, device="cpu")
    stats = mcmc.run().stats["h"]
    assert set(stats) == {"accept", "proposal", "logp"}
    assert stats["accept"].dtype == torch.int32 and stats["accept"].shape == (64,)
    assert bool(torch.all(stats["proposal"] == 100)) and bool(torch.all(stats["accept"] <= 100))

    res = build("openmcmc_tpu_torch", "loop_vectorized", 16, 10, 20, seed=3, device="cpu").run()
    assert bool(torch.all(res.stats["omega"]["proposal"] == 3 * 30)) and "logp" not in res.stats["omega"]

    from openmcmc_tpu_torch import MCMC
    from openmcmc_tpu_torch.samplers import RandomWalk

    base = build("openmcmc_tpu_torch", "rw", 8, 1, 1, seed=0, device="cpu")
    sampler = RandomWalk("h", base.model, step=60.0, adapt_step=True, target_accept=0.44)
    state = {**base.data, "h": 175.0}
    res = MCMC(state, [sampler], base.model, n_burn=600, n_iter=300, n_chains=128, seed=4, device="cpu").run()
    log_step = res.stats["h"]["log_step"]
    assert log_step.shape == (128, 1, 1)
    assert float(torch.exp(log_step).mean()) < 25.0
    rate = float(res.acceptance["h"].mean()) / 100.0
    assert 0.3 < rate < 0.6, rate


def test_truncated_walk_from_the_box_edge():
    """(e) A chain started exactly on the lower edge of its proposal box, and one
    started outside it, never produce a NaN: the reverse density is finite on
    the edge and -inf outside, which rejects the move (-inf - -inf is never
    accepted)."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Normal
    from openmcmc_tpu_torch.samplers import RandomWalk

    mdl = Model([Normal("theta", mean="m0", precision="p0")])
    for start, moves in ((0.0, True), (-1.0, False)):
        sampler = RandomWalk("theta", mdl, step=0.5, domain_limits=[[0.0, 4.0]])
        res = MCMC({"theta": start, "m0": 1.0, "p0": np.eye(1)}, [sampler], mdl, n_burn=0, n_iter=50, n_chains=16,
                   seed=5, device="cpu").run()
        theta = res.store["theta"]
        assert bool(torch.all(torch.isfinite(theta))) and bool(torch.all(torch.isfinite(res.log_post)))
        if moves:
            assert float(theta.min()) >= 0.0 and int(res.stats["theta"]["accept"].sum()) > 0
        else:
            assert bool(torch.all(theta == -1.0)) and int(res.stats["theta"]["accept"].sum()) == 0


def test_carried_logp_decisions_match_jax():
    """(f) _carried_logp_params in both packages: a single RandomWalk or
    ManifoldMALA carries its density; a random walk whose inputs another sampler
    moves does not; RandomWalkLoop never does; two independent walks both do."""
    def sweep(pkg, kind):
        dist = importlib.import_module(f"{pkg}.distributions")
        smp = importlib.import_module(f"{pkg}.samplers")
        Model = importlib.import_module(f"{pkg}.model").Model
        MCMC = importlib.import_module(f"{pkg}.mcmc").MCMC
        params = importlib.import_module(f"{pkg}.parameters")
        mdl = Model([dist.Normal("y", mean="h", precision=params.ScaledMatrix("P", "tau")),
                     dist.Normal("h", mean="mu", precision="lam"), dist.Gamma("tau", shape="a", rate="b"),
                     dist.Normal("g", mean="mu", precision="lam")])
        samplers = {
            "single": [smp.RandomWalk("h", mdl)],
            "shared": [smp.RandomWalk("h", mdl), smp.NormalGamma("tau", mdl)],
            "loop": [smp.RandomWalkLoop("h", mdl)],
            "mmala": [smp.ManifoldMALA("h", mdl)],
            "independent": [smp.RandomWalk("h", mdl), smp.RandomWalk("g", mdl)],
        }[kind]
        state = {"y": np.zeros((2, 1)), "h": np.zeros((2, 1)), "g": np.zeros((2, 1)), "mu": np.zeros((2, 1)),
                 "lam": np.eye(2), "P": np.eye(2), "tau": 1.0, "a": 1.0, "b": 1.0}
        kw = {"device": "cpu"} if pkg == "openmcmc_tpu_torch" else {}
        return MCMC(state, samplers, mdl, n_burn=1, n_iter=1, n_chains=2, **kw)._carried_logp_params()

    for kind, want in (("single", {"h"}), ("shared", set()), ("loop", set()), ("mmala", {"h"}),
                       ("independent", {"h", "g"})):
        assert sweep("openmcmc_tpu", kind) == sweep("openmcmc_tpu_torch", kind) == frozenset(want), kind
