"""The port's spectral smoother (openmcmc_tpu_torch.fused.spectral) against the JAX package's.

The JAX engine runs its Pallas kernel in interpret mode with a host bit source,
so its random bits are known exactly: for sweep ``it``, draw site ``k`` and grid
program 0 they are ``jax.random.bits(fold_in(fold_in(PRNGKey(seed), it), k),
shape)``. The port's plain engine is fed the same bits (first p rows, chains
leading) and must reproduce the JAX engine's draws to float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openmcmc_tpu.fused import prng as jprng
from openmcmc_tpu.fused import spectral as jspectral
from openmcmc_tpu_torch.fused import spectral as tspectral

torch.set_num_threads(2)


@pytest.fixture
def host_stats():
    """Interpret mode + host threefry bits; caches cleared so no executable traced
    with the zero-stub (or a previous source) is reused."""
    jax.clear_caches()
    src = jprng.HostBitSource()
    with pltpu.force_tpu_interpret_mode(), jprng.host_bits(src):
        yield src
    jax.clear_caches()


def jax_kernel_bits(seed, p):
    """The bits the interpret-mode JAX smoother kernel draws in grid program 0, as
    a port bit source ``(sweep, site, (chains, width)) -> (chains, width)``."""
    p_pad = p + (-p) % jspectral.PAD
    block = jspectral._block_b(p_pad)
    base = jax.random.PRNGKey(seed)

    def source(it, site, shape):
        chains, width = shape
        rows = p_pad if site == 0 else width
        key = jax.random.fold_in(jax.random.fold_in(base, it), site)
        bits = np.asarray(jax.random.bits(key, (rows, block), jnp.uint32))
        return torch.from_numpy(bits[:width, :chains].T.astype(np.int64))

    return source


def rw1_problem(p=12, seed=0):
    from openmcmc_tpu.linalg import gmrf
    from openmcmc_tpu.linalg import structured as st

    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 10.0, p)
    y = np.sin(s) + rng.normal(0.0, 0.5, p)
    P0 = np.asarray(st.to_dense(gmrf.precision_irregular(jnp.asarray(s, jnp.float32))), np.float64)
    return dict(y=y, P0=P0)


def lattice_problem(side=5, seed=1):
    rng = np.random.default_rng(seed)
    p = side * side
    d = np.diag(np.ones(side - 1), 1) + np.diag(np.ones(side - 1), -1)
    lap = 4.0 * np.eye(p) - np.kron(np.eye(side), d) - np.kron(d, np.eye(side))
    return dict(
        y=rng.normal(size=p), P0=lap + 0.01 * np.eye(p),
        noise_diag=rng.uniform(0.5, 2.0, p), mu0=0.1 * rng.normal(size=p),
    )


HYPERS = dict(a_lam=10.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, lam0=5.0, tau0=1.0)


def assert_same_draws(got, want, what=""):
    for name in ("b", "lam", "tau"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {name}")
    lp_t, lp_j = got["log_post"].numpy(), np.asarray(want["log_post"])
    assert np.all(np.abs(lp_t - lp_j) <= 1e-4 * np.maximum(1.0, np.abs(lp_j))), (what, lp_t, lp_j)


@pytest.mark.parametrize("problem", [rw1_problem(), lattice_problem()], ids=["rw1_p12", "lattice_p25"])
def test_host_preparation_matches_jax(problem):
    P0, y = problem["P0"], problem["y"]
    p = y.shape[0]
    d = problem.get("noise_diag", np.ones(p))
    mu0 = problem.get("mu0", np.zeros(p))
    prep = tspectral.prepare(y, P0, noise_diag=problem.get("noise_diag"), mu0=problem.get("mu0"))
    V, s = jspectral._eigenbasis(P0, d)
    s = np.maximum(s, 0.0)
    np.testing.assert_array_equal(prep["V"], V)
    np.testing.assert_array_equal(prep["s"], s)
    np.testing.assert_array_equal(prep["wy"], V.T @ (d * y))
    np.testing.assert_array_equal(prep["wmu"], V.T @ (d * mu0))
    assert prep["logdet_d"] == float(np.sum(np.log(d)))
    assert prep["logdet_p0"] == prep["logdet_d"] + float(np.sum(np.log(np.maximum(s, 1e-300))))


@pytest.mark.parametrize("n_thin", [1, 2])
@pytest.mark.parametrize("problem,n_chains", [(rw1_problem(), 8), (lattice_problem(), 40)],
                         ids=["rw1_p12", "lattice_p25"])
def test_same_bits_engine_parity(host_stats, problem, n_chains, n_thin):
    seed = 3
    kw = dict(problem, n_burn=3, n_iter=5, n_chains=n_chains, n_thin=n_thin, **HYPERS)
    want = jspectral.run_spectral_smoother(seed, **kw)
    got = tspectral.run_spectral_smoother(seed, **kw, device="cpu",
                                        bit_source=jax_kernel_bits(seed, problem["y"].shape[0]))
    assert got["b"].shape == (n_chains, 5, problem["y"].shape[0])
    assert_same_draws(got, want, f"n_thin={n_thin}")


def test_kernel_log_post_is_model_log_p():
    """The engine's analytic log_post equals the port's Model.log_p at the stored draws."""
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.model import Model
    from openmcmc_tpu_torch.parameters import ScaledMatrix

    pb = lattice_problem()
    p = pb["y"].shape[0]
    out = tspectral.run_spectral_smoother(11, n_burn=2, n_iter=4, n_chains=8, **pb, **HYPERS, device="cpu")
    mdl = Model([
        Normal("y", mean="b", precision=ScaledMatrix("D", "tau")),
        Normal("b", mean="mu0", precision=ScaledMatrix("P0", "lam")),
        Gamma("lam", shape="a_lam", rate="b_lam"),
        Gamma("tau", shape="a_tau", rate="b_tau"),
    ])
    f32 = dict(dtype=torch.float32)
    base = {
        "y": torch.tensor(pb["y"], **f32).reshape(-1, 1), "D": st.Diagonal(torch.tensor(pb["noise_diag"], **f32)),
        "P0": st.Dense(torch.tensor(pb["P0"], **f32)), "mu0": torch.tensor(pb["mu0"], **f32).reshape(-1, 1),
        "a_lam": torch.full((1, 1), 10.0), "b_lam": torch.ones((1, 1)),
        "a_tau": torch.ones((1, 1)), "b_tau": torch.ones((1, 1)),
    }
    for c in range(3):
        for t in range(4):
            state = dict(base, b=out["b"][c, t].reshape(p, 1), lam=out["lam"][c, t].reshape(1, 1),
                         tau=out["tau"][c, t].reshape(1, 1))
            want = float(mdl.log_p(state))
            got = float(out["log_post"][c, t])
            assert abs(got - want) < 1e-4 * max(1.0, abs(want)), (c, t, got, want)


def test_philox_engine_matches_generic_driver_moments():
    """With its own Philox bits the port's engine samples the posterior of the JAX
    generic driver (thresholds of tests/test_fused_engines_cpu_stats.py)."""
    from test_fused_engines_cpu_stats import _check_smoother_parity, _generic_smoother, _smoother_problem

    from openmcmc_tpu.linalg import gmrf
    from openmcmc_tpu.linalg import structured as st

    s, y = _smoother_problem()
    P0 = np.asarray(jax.jit(lambda v: st.to_dense(gmrf.precision_irregular(v)))(jnp.asarray(s, jnp.float32)))
    out = tspectral.run_spectral_smoother(4, y, P0, n_burn=200, n_iter=200, n_chains=1024,
                                          a_lam=2.0, b_lam=1.0, a_tau=2.0, b_tau=1.0, lam0=1.0, tau0=1.0,
                                          device="cpu")
    gen = _generic_smoother(s, y)
    _check_smoother_parity(out["b"].numpy(), out["lam"].numpy(), out["tau"].numpy(), gen)
