"""The port's Thomas-scan smoother (openmcmc_tpu_torch.fused.gmrf_smoother, kernel
K4's plain version) and the truncated-normal layer it inlines, against the JAX
package's ``fused/gmrf_smoother.py`` and ``fused/prng.py``.

The JAX engine runs its Pallas kernel in interpret mode with a host bit source
(see tests/test_torch_spectral.py), so its bits are known: for sweep ``it``,
draw site ``k`` and grid program 0 they are ``jax.random.bits(fold_in(fold_in(
PRNGKey(seed), it), k), shape)``. Its wide sites are (p_pad, 2048): p padded to
a multiple of 8, chains on 2048 lanes. The port's plain engine takes the first p
rows and the first chains and must reproduce the JAX engine's draws to float32
rounding (rtol 1e-4, atol 1e-5; log_post 1e-4 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmcmc_tpu.fused import gmrf_smoother as jgs
from openmcmc_tpu.fused import prng as jprng
from openmcmc_tpu_torch.fused import gmrf_smoother as tgs
from openmcmc_tpu_torch.fused import prng as tprng
from test_torch_prng import SharedBits
from test_torch_spectral import assert_same_draws, host_stats  # noqa: F401  (host_stats is a fixture)

torch.set_num_threads(2)

P = 12
HYPERS = dict(a_lam=10.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, lam0=5.0, tau0=1.0)


def jax_kernel_bits(seed, p, n_wide):
    """The bits the interpret-mode JAX Thomas kernel draws in grid program 0, as a
    port bit source ``(sweep, site, (chains, width)) -> (chains, width)``; the
    first ``n_wide`` sites span p_pad rows."""
    p_pad = p + (-p) % jgs.CHUNK
    block = jgs._block_b(p_pad)
    base = jax.random.PRNGKey(seed)

    def source(it, site, shape):
        chains, width = shape
        rows = p_pad if site < n_wide else width
        key = jax.random.fold_in(jax.random.fold_in(base, it), site)
        bits = np.asarray(jax.random.bits(key, (rows, block), jnp.uint32))
        return torch.from_numpy(bits[:width, :chains].T.astype(np.int64))

    return source


def smoother_problem(seed=0):
    rng = np.random.default_rng(seed)
    s = np.linspace(0.0, 10.0, P)
    y = np.sin(s) + rng.normal(0.0, 0.5, P)
    return dict(y=y, s=s, noise_diag=rng.uniform(0.5, 2.0, P), mu0=0.1 * rng.normal(size=P))


def test_erf_poly_and_truncnorm_draw_match_jax():
    """(a) erf_poly on the same inputs and truncnorm_draw on the same uint32 bits as
    the JAX functions: a two-sided box, one-sided boxes, +-1e30 on both sides, a
    narrow box and a box far in the tail. Tolerance: float32 rounding of exp and
    log on two libraries, 4e-7 absolute on erf (a few ulp at 1) and rtol 2e-6
    plus atol 1e-6 on the draws."""
    rng = np.random.default_rng(0)
    n = 512
    x = np.concatenate([rng.normal(0.0, 2.0, n - 6), [0.0, 1e-8, 1e30, -1e30, 7.0, -40.0]]).astype(np.float32)
    erf_t = tprng.erf_poly(torch.from_numpy(x)).numpy()
    erf_j = np.asarray(jprng.erf_poly(jnp.asarray(x)))
    assert np.max(np.abs(erf_t - erf_j)) <= 4e-7
    assert erf_t[-4] == 1.0 and erf_t[-3] == -1.0

    big = 1e30
    #            lo     hi     mu shift  scale
    boxes = [(0.0, 1.2, 0.5, 0.3), (0.0, big, -1.0, 0.7), (-big, 0.5, 1.5, 2.0), (-big, big, 0.2, 1.3),
             (1.0, 1.001, 0.0, 0.4), (3.0, 4.0, 0.0, 0.5)]
    rows = len(boxes)
    lo = np.array([[b[0]] * n for b in boxes], np.float32)
    hi = np.array([[b[1]] * n for b in boxes], np.float32)
    mu = np.array([b[2] + rng.normal(0.0, 1.0, n) for b in boxes], np.float32)
    scale = np.array([[b[3]] * n for b in boxes], np.float32)
    bits = SharedBits(1)
    want = np.asarray(jprng.truncnorm_draw(*(jnp.asarray(v) for v in (mu, scale, lo, hi)), (rows, n),
                                           bit_source=bits.jax))
    got = tprng.truncnorm_draw(*(torch.from_numpy(v.T.copy()) for v in (mu, scale, lo, hi)), (n, rows),
                               bits.port()).numpy().T
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    assert np.all(np.isfinite(got)) and np.all((got >= lo) & (got <= hi))


def test_truncnorm_draws_plain_is_truncnorm_draw_on_philox_words():
    """The K2 check kernel's plain version: erf_poly of x, and truncnorm_draw on the
    4 Philox words of each counter row."""
    rng = np.random.default_rng(2)
    n = 64
    ctr = torch.from_numpy(rng.integers(0, 2**31 - 1, (n, 4)).astype(np.int32))
    x, mu = (torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)) for _ in range(2))
    scale = torch.full((n, 4), 0.5)
    lo, hi = torch.full((n, 4), -0.2), torch.full((n, 4), 1e30)
    erf, draw = tprng.truncnorm_draws(9, ctr, x, mu, scale, lo, hi)
    c = ctr.to(torch.int64) & 0xFFFFFFFF
    words = torch.stack(tprng.philox4x32(c[:, 0], c[:, 1], c[:, 2], c[:, 3], 9), dim=1)
    assert torch.equal(erf, tprng.erf_poly(x))
    assert torch.equal(draw, tprng.truncnorm_draw(mu, scale, lo, hi, (n, 4), lambda shape: words))
    assert bool(torch.all(draw >= lo))


@pytest.mark.parametrize("n_thin", [1, 2])
def test_thomas_engine_matches_jax(host_stats, n_thin):  # noqa: F811
    """(b) The Thomas variant with a non-identity D and a nonzero mu0, 8 chains,
    3 burn-in sweeps and 5 stored draws."""
    seed = 3
    kw = dict(smoother_problem(), n_burn=3, n_iter=5, n_chains=8, n_thin=n_thin, **HYPERS)
    want = jgs.run_fused_smoother(seed, **kw)
    got = tgs.run_fused_smoother(seed, **kw, device="cpu", bit_source=jax_kernel_bits(seed, P, 1))
    assert got["b"].shape == (8, 5, P) and got["lam"].shape == (8, 5)
    assert_same_draws(got, want, f"thomas n_thin={n_thin}")


@pytest.mark.parametrize("b_init,n_thin", [(None, 1), ("given", 2)], ids=["default_init", "given_init"])
def test_truncated_engine_matches_jax(host_stats, b_init, n_thin):  # noqa: F811
    """(b) The truncated variant with an active box [0, 1.2] (y has entries on both
    sides), from y clipped into the box or from a given b_init."""
    seed = 5
    pb = smoother_problem(1)
    init = None if b_init is None else np.random.default_rng(4).uniform(-1.0, 2.0, P)
    kw = dict(pb, n_burn=3, n_iter=5, n_chains=8, n_thin=n_thin, lower=np.zeros(P), upper=np.full(P, 1.2),
              b_init=init, **HYPERS)
    want = jgs.run_fused_smoother(seed, **kw)
    got = tgs.run_fused_smoother(seed, **kw, device="cpu", bit_source=jax_kernel_bits(seed, P, 2))
    assert_same_draws(got, want, f"truncated b_init={b_init}")
    b = got["b"].numpy()
    assert b.min() >= 0.0 and b.max() <= 1.2


def _port_model(truncated):
    from openmcmc_tpu_torch import Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.parameters import ScaledMatrix

    box = dict(domain_response_lower=0.0, domain_response_upper=1.2) if truncated else {}
    return Model([
        Normal("y", mean="b", precision=ScaledMatrix("D", "tau")),
        Normal("b", mean="mu0", precision=ScaledMatrix("P0", "lam"), **box),
        Gamma("lam", shape="a_lam", rate="b_lam"),
        Gamma("tau", shape="a_tau", rate="b_tau"),
    ])


@pytest.mark.parametrize("truncated", [False, True], ids=["thomas", "truncated"])
def test_log_post_is_model_log_p(truncated):
    """(c) The engine's analytic log_post equals the port's Model.log_p at every
    stored draw (8 chains x 4 draws, Philox bits), within 1e-4 relative; the
    truncated variant's draws lie in the box, where the truncated density is
    the untruncated one."""
    from openmcmc_tpu_torch.linalg import structured as st

    pb = smoother_problem(2)
    box = dict(lower=0.0, upper=1.2) if truncated else {}
    out = tgs.run_fused_smoother(11, **pb, n_burn=2, n_iter=4, n_chains=8, **HYPERS, **box, device="cpu")
    prep = tgs.prepare(pb["y"], pb["s"], noise_diag=pb["noise_diag"], mu0=pb["mu0"], device="cpu")
    f32 = dict(dtype=torch.float32)
    n = 8 * 4
    state = {
        "y": prep["y"].reshape(-1, 1), "D": st.Diagonal(prep["d"]), "mu0": prep["mu"].reshape(-1, 1),
        "P0": st.Banded(torch.stack([prep["p0d"], prep["p0c"]])),
        "a_lam": torch.full((1, 1), 10.0), "b_lam": torch.ones((1, 1)),
        "a_tau": torch.ones((1, 1)), "b_tau": torch.ones((1, 1)),
        "b": out["b"].reshape(n, P, 1), "lam": out["lam"].reshape(n, 1, 1).to(**f32),
        "tau": out["tau"].reshape(n, 1, 1),
    }
    want = _port_model(truncated).log_p(state).numpy()
    got = out["log_post"].reshape(-1).numpy()
    assert np.all(np.isfinite(want))
    assert np.all(np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))), (got, want)


def test_philox_stream_and_input_checks():
    """A chain's draws depend on (seed, chain, sweep, site) only: the first 5 of
    13 chains equal a 5-chain run (p = 7, not a multiple of 4); per-chain lam0
    and b_init rows are taken as given; malformed inputs raise."""
    pb = smoother_problem(3)
    y, s = pb["y"][:7], pb["s"][:7]
    box = dict(lower=-0.5, upper=np.full(7, 1.0))
    lam0 = np.linspace(1.0, 20.0, 13)
    b_init = np.random.default_rng(5).uniform(-0.5, 1.0, (13, 7))
    full = tgs.run_fused_smoother(2, y, s, 2, 3, 13, lam0=lam0, b_init=b_init, n_thin=2, device="cpu", **box)
    head = tgs.run_fused_smoother(2, y, s, 2, 3, 5, lam0=lam0[:5], b_init=b_init[:5], n_thin=2, device="cpu", **box)
    for name in ("b", "lam", "tau", "log_post"):
        assert torch.equal(full[name][:5], head[name]), name
    other = tgs.run_fused_smoother(2, y, s, 2, 3, 5, lam0=lam0[5:10], b_init=b_init[:5], n_thin=2, device="cpu",
                                   **box)
    assert not torch.equal(other["lam"], head["lam"])

    prep = tgs.prepare(y, s, device="cpu")
    vecs = [prep[k] for k in ("p0d", "p0c", "y", "d", "mu", "p0mu")]
    rows = [torch.ones(4), torch.ones(4)]
    kw = dict(logdet_p0=0.0, logdet_d=0.0, a_lam=1.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, n_burn=0, n_keep=1)
    with pytest.raises(ValueError, match="together"):
        tgs.gmrf_smoother(0, *vecs, *rows, lo=prep["y"], **kw)
    with pytest.raises(ValueError, match="p0c must have shape"):
        tgs.gmrf_smoother(0, vecs[0], vecs[1][:6], *vecs[2:], *rows, **kw)
    with pytest.raises(ValueError, match="CPU only"):
        tgs.gmrf_smoother_plain(0, *(v.to("meta") for v in vecs), *(r.to("meta") for r in rows),
                                bit_source=lambda *a: None, **kw)
