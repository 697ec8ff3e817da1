"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

Marked ``cuda``: these skip without a CUDA device (the kernels have no CPU
mode). On a machine with one: ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("a1,a2", [(60.0, 51.0), (2.5, 0.5)])
def test_prng_draws_kernel_matches_plain(dev, a1, a2):
    from openmcmc_tpu_torch.fused import prng

    ctr = torch.randint(0, 2**31 - 1, (4096, 4), dtype=torch.int32, generator=torch.Generator().manual_seed(0))
    ctr = ctr.to(dev)
    before = prng.draws.launches
    got = prng.draws(5, ctr, a1, a2, 2.0, 0.5)
    want = prng.draws_plain(5, ctr, a1, a2, 2.0, 0.5)
    torch.cuda.synchronize()
    assert prng.draws.launches == before + 1
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "p,n_chains,n_thin,a_lam",
    [(1, 64, 1, 0.2), (12, 40, 1, 2.0), (100, 96, 2, 2.0), (300, 16, 2, 2.0)],
    ids=["p1_shape_below_1", "p12", "p100_smem", "p300_global"],
)
def test_spectral_kernel_matches_plain(dev, p, n_chains, n_thin, a_lam):
    from openmcmc_tpu_torch.fused import spectral

    rng = np.random.default_rng(p)
    A = rng.normal(size=(p, p))
    P0 = A @ A.T / p + 0.1 * np.eye(p)
    prep = spectral.prepare(rng.normal(size=p), P0, noise_diag=rng.uniform(0.5, 2.0, p), mu0=rng.normal(size=p))
    f32 = dict(dtype=torch.float32, device=dev)
    args = [torch.as_tensor(prep[k], **f32).contiguous() for k in ("V", "s", "wy", "wmu")]
    args += [torch.full((n_chains,), 3.0, **f32), torch.full((n_chains,), 1.0, **f32)]
    kw = dict(logdet_p0=prep["logdet_p0"], logdet_d=prep["logdet_d"], a_lam=a_lam, b_lam=1.0, a_tau=2.0,
              b_tau=1.0, n_burn=4, n_keep=6, n_thin=n_thin)
    before = spectral.smoother_sweeps_kernel.launches
    got = spectral.smoother_sweeps(9, *args, **kw)
    want = spectral.smoother_sweeps_plain(9, *args, **kw)
    torch.cuda.synchronize()
    assert spectral.smoother_sweeps_kernel.launches == before + 1
    for name in ("b", "lam", "tau"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-5)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))


def test_cuda_path_refuses_injected_bits(dev):
    from openmcmc_tpu_torch.fused import spectral

    V = torch.eye(3, device=dev)
    v = torch.ones(3, device=dev)
    c = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="CPU only"):
        spectral.smoother_sweeps(0, V, v, v, v, c, c, bit_source=lambda *a: None, logdet_p0=0.0,
                                 logdet_d=0.0, a_lam=1.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, n_burn=0, n_keep=1)


@pytest.mark.parametrize("n_chains,p", [(8192, 100), (1000, 4099)], ids=["main_path", "ragged"])
def test_tridiag_kernel_matches_plain(dev, n_chains, p):
    """K3 against its plain version on the same Philox bits; rtol 1e-4, atol 1e-5."""
    from openmcmc_tpu_torch.linalg import tridiag

    rng = np.random.default_rng(p)
    c = rng.uniform(-1.0, 1.0, (n_chains, p))
    c[:, -1] = 0.0
    a = 2.5 + rng.uniform(0.0, 3.0, (n_chains, p))
    b = rng.normal(size=(n_chains, p))
    a, c, b = (torch.as_tensor(t, dtype=torch.float32, device=dev) for t in (a, c, b))
    before = tridiag.sample_canonical_tridiag_kernel.launches
    got = tridiag.sample_canonical_tridiag(3, 41, a, c, b)
    want = tridiag.sample_canonical_tridiag_plain(3, 41, a, c, b)
    torch.cuda.synchronize()
    assert tridiag.sample_canonical_tridiag_kernel.launches == before + 1
    assert got.shape == (n_chains, p)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_generic_run_launches_k3_once_per_sweep(dev):
    """The generic driver on a small flagship-shaped model (p = 16, 64 chains,
    n_burn 3, n_iter 5, n_thin 2): one K3 launch per sweep, 3 * 2 + 5 * 2 = 16."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.linalg import gmrf, structured as st, tridiag
    from openmcmc_tpu_torch.parameters import ScaledMatrix
    from openmcmc_tpu_torch.samplers import NormalGamma, NormalNormal

    p = 16
    s = np.linspace(0.0, 60.0, p)
    P0 = gmrf.precision_irregular(s)
    bands = P0.bands.clone()
    bands[0, 0] += 1e-3
    y = np.sin(s / 20.0) + np.random.default_rng(0).normal(size=p)
    mdl = Model([
        Normal("y", mean="b", precision=ScaledMatrix("P_tau", "tau")),
        Normal("b", mean="mu", precision=ScaledMatrix("P_lambda", "lambda")),
        Gamma("lambda", shape="a_lam", rate="b_lam"),
        Gamma("tau", shape="a_tau", rate="b_tau"),
    ])
    state = {"y": y, "b": y.copy(), "mu": np.zeros(p), "lambda": 100.0, "P_lambda": st.Banded(bands),
             "a_lam": 10.0, "b_lam": 1.0, "tau": 1.0, "P_tau": st.Diagonal(torch.ones(p)), "a_tau": 1.0,
             "b_tau": 1.0}
    mcmc = MCMC(state, [NormalNormal("b", mdl), NormalGamma("lambda", mdl), NormalGamma("tau", mdl)], mdl,
                n_burn=3, n_iter=5, n_thin=2, n_chains=64, seed=7)
    before = tridiag.sample_canonical_tridiag_kernel.launches
    res = mcmc.run()
    torch.cuda.synchronize()
    assert res.engine == "generic"
    assert tridiag.sample_canonical_tridiag_kernel.launches == before + 16
    assert res.store["b"].device.type == "cuda" and tuple(res.store["b"].shape) == (64, 5, p, 1)
    assert all(bool(torch.all(torch.isfinite(v))) for v in (*res.store.values(), res.log_post))


def test_truncnorm_draws_kernel_matches_plain(dev):
    """erf_poly and truncnorm_draw on the card against their plain versions: open
    (+-1e30), one-sided and narrow boxes; rtol 1e-6, atol 1e-6."""
    from openmcmc_tpu_torch.fused import prng

    gen = torch.Generator().manual_seed(1)
    n = 4096
    ctr = torch.randint(0, 2**31 - 1, (n, 4), dtype=torch.int32, generator=gen)
    x = 3.0 * torch.randn((n, 4), generator=gen)
    x[0] = torch.tensor([1e30, -1e30, 0.0, 40.0])
    mu = torch.randn((n, 4), generator=gen)
    scale = torch.rand((n, 4), generator=gen) + 0.1
    lo = torch.tensor([0.0, -1e30, 1.0, -1e30]).expand(n, 4).contiguous()
    hi = torch.tensor([1.2, 0.5, 1.001, 1e30]).expand(n, 4).contiguous()
    args = [t.to(dev) for t in (x, mu, scale, lo, hi)]
    before = prng.truncnorm_draws.launches
    got = prng.truncnorm_draws(3, ctr.to(dev), *args)
    want = prng.truncnorm_draws_plain(3, ctr.to(dev), *args)
    torch.cuda.synchronize()
    assert prng.truncnorm_draws.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    assert bool(torch.all((got[1] >= args[3]) & (got[1] <= args[4])))


def _k4_inputs(dev, n_chains, p, truncated):
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs

    rng = np.random.default_rng(p)
    s = np.cumsum(rng.uniform(0.2, 1.0, p))
    y = np.sin(s / 5.0) + rng.normal(0.0, 0.5, p)
    box = dict(lower=-0.3, upper=np.full(p, 1.0)) if truncated else {}
    prep = gs.prepare(y, s, noise_diag=rng.uniform(0.5, 2.0, p), mu0=0.1 * rng.normal(size=p), device=dev, **box)
    f32 = dict(dtype=torch.float32, device=dev)
    args = [prep[k] for k in ("p0d", "p0c", "y", "d", "mu", "p0mu")]
    args += [torch.full((n_chains,), 20.0, **f32), torch.full((n_chains,), 1.0, **f32)]
    kw = dict(logdet_p0=prep["logdet_p0"], logdet_d=prep["logdet_d"], a_lam=2.0, b_lam=1.0, a_tau=2.0, b_tau=1.0)
    if truncated:
        kw.update(lo=prep["lo"], hi=prep["hi"], b_init=prep["b_init"].expand(n_chains, p).contiguous())
    return args, kw


@pytest.mark.parametrize("truncated", [False, True], ids=["thomas", "truncated"])
@pytest.mark.parametrize("n_chains,p", [(64, 12), (1000, 1031)], ids=["small", "ragged"])
def test_gmrf_smoother_kernel_matches_plain(dev, truncated, n_chains, p):
    """K4 against its plain version on the same Philox bits, n_burn 3, n_keep 4,
    n_thin 2; b, lam, tau rtol 1e-4 atol 1e-5, log_post 1e-4 relative."""
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs

    args, kw = _k4_inputs(dev, n_chains, p, truncated)
    kw.update(n_burn=3, n_keep=4, n_thin=2)
    before = gs.gmrf_smoother_kernel.launches
    got = gs.gmrf_smoother(13, *args, **kw)
    want = gs.gmrf_smoother_plain(13, *args, **kw)
    torch.cuda.synchronize()
    assert gs.gmrf_smoother_kernel.launches == before + 1
    for name in ("b", "lam", "tau"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-5)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))


def test_truncated_auto_run_launches_k4_once(dev):
    """MCMC.run(engine="auto") on a box-truncated smoother: engine
    fused_gmrf_smoother_truncated, one K4 launch, every draw in the box."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs
    from openmcmc_tpu_torch.linalg import gmrf, structured as st
    from openmcmc_tpu_torch.parameters import ScaledMatrix
    from openmcmc_tpu_torch.samplers import NormalGamma, NormalNormal

    p = 50
    s = np.linspace(0.0, 60.0, p)
    bands = gmrf.precision_irregular(s).bands.clone()
    bands[0, 0] += 1e-3
    y = np.sin(s / 20.0) + 2.0 * np.cos(s / 12.0) + 2.0 + np.random.default_rng(0).normal(size=p)
    mdl = Model([
        Normal("y", mean="b", precision=ScaledMatrix("P_tau", "tau")),
        Normal("b", mean="mu", precision=ScaledMatrix("P_lambda", "lambda"), domain_response_lower=0.0,
               domain_response_upper=3.5),
        Gamma("lambda", shape="a_lam", rate="b_lam"),
        Gamma("tau", shape="a_tau", rate="b_tau"),
    ])
    state = {"y": y, "b": np.clip(y, 1e-3, 3.5 - 1e-3), "mu": np.zeros(p), "lambda": 100.0,
             "P_lambda": st.Banded(bands), "a_lam": 10.0, "b_lam": 1.0, "tau": 1.0,
             "P_tau": st.Diagonal(torch.ones(p)), "a_tau": 1.0, "b_tau": 1.0}
    mcmc = MCMC(state, [NormalNormal("b", mdl), NormalGamma("lambda", mdl), NormalGamma("tau", mdl)], mdl,
                n_burn=10, n_iter=20, n_chains=96, seed=3)
    before = gs.gmrf_smoother_kernel.launches
    res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    assert res.engine == "fused_gmrf_smoother_truncated"
    assert gs.gmrf_smoother_kernel.launches == before + 1
    b = res.store["b"]
    assert b.device.type == "cuda" and tuple(b.shape) == (96, 20, p, 1)
    assert float(b.min()) >= 0.0 and float(b.max()) <= 3.5
    assert bool(torch.all(torch.isfinite(res.log_post)))


def _linreg_problem(dev, N, p, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, p))
    y = X @ rng.normal(size=p) + 0.5 * rng.normal(size=N)
    return X, y, dict(plam_diag=rng.uniform(0.5, 2.0, p), ptau_diag=rng.uniform(0.5, 2.0, N),
                      mu=0.3 * rng.normal(size=p))


def _assert_kernel_matches_plain(got, want):
    for name in ("beta", "lam", "tau"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-5)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))


@pytest.mark.parametrize("p,a_lam", [(1, 0.2), (2, 1e-3), (7, 2.0), (16, 2.0)],
                         ids=["p1_shape_below_1", "p2", "p7", "p16"])
def test_linreg_kernel_matches_plain(dev, p, a_lam):
    """K6 against its plain version on the same Philox bits: 200 chains (ragged
    against the 32-thread blocks), n_burn 4, n_keep 6, n_thin 2; beta, lam, tau
    rtol 1e-4 atol 1e-5, log_post 1e-4 relative."""
    from openmcmc_tpu_torch.fused import linreg

    X, y, extra = _linreg_problem(dev, 60, p, p)
    f32 = dict(dtype=torch.float32, device=dev)
    G, c, scal = linreg.sufficient_statistics(torch.as_tensor(X, **f32), torch.as_tensor(y, **f32),
                                              torch.as_tensor(extra["plam_diag"], **f32),
                                              torch.as_tensor(extra["ptau_diag"], **f32))
    args = [G, c, torch.as_tensor(extra["plam_diag"], **f32), torch.as_tensor(extra["mu"], **f32), scal,
            torch.full((200,), 0.5, **f32), torch.full((200,), 1.0, **f32)]
    kw = dict(n_obs=60.0, a_lam=a_lam, b_lam=1.0, a_tau=2.0, b_tau=1.0, n_burn=4, n_keep=6, n_thin=2)
    before = linreg.linreg_sweeps_kernel.launches
    got = linreg.linreg_sweeps(5, *args, **kw)
    want = linreg.linreg_sweeps_plain(5, *args, **kw)
    torch.cuda.synchronize()
    assert linreg.linreg_sweeps_kernel.launches == before + 1
    assert tuple(got["beta"].shape) == (200, 6, p)
    _assert_kernel_matches_plain(got, want)


@pytest.mark.parametrize("N,p", [(80, 24), (600, 250)], ids=["p24_smem", "p250_global"])
def test_spectral_linreg_kernel_matches_plain(dev, N, p):
    """K5 against its plain version on the same Philox bits: 100 chains, n_burn
    3, n_keep 5, n_thin 2; V in shared memory at p = 24, in global memory at the
    ragged p = 250 (eight 32-row sum windows)."""
    from openmcmc_tpu_torch.fused import spectral

    X, y, extra = _linreg_problem(dev, N, p, p)
    prep = spectral.prepare_linreg(X, y, **extra)
    f32 = dict(dtype=torch.float32, device=dev)
    args = [torch.as_tensor(prep[k], **f32).contiguous() for k in ("V", "s", "wmu", "cv")]
    args += [torch.full((100,), 0.5, **f32), torch.full((100,), 1.0, **f32)]
    kw = {k: float(np.float32(prep[k])) for k in ("yPy", "logdet_plam", "logdet_ptau")}
    kw.update(n_obs=float(N), a_lam=2.0, b_lam=1.0, a_tau=2.0, b_tau=1.0, n_burn=3, n_keep=5, n_thin=2)
    before = spectral.spectral_linreg_sweeps_kernel.launches
    got = spectral.spectral_linreg_sweeps(3, *args, **kw)
    want = spectral.spectral_linreg_sweeps_plain(3, *args, **kw)
    torch.cuda.synchronize()
    assert spectral.spectral_linreg_sweeps_kernel.launches == before + 1
    assert tuple(got["beta"].shape) == (100, 5, p)
    _assert_kernel_matches_plain(got, want)


def _assert_mh_matches_plain(got, want, draw):
    """A Metropolis kernel against its plain version: draws rtol 1e-4 atol 1e-5,
    log_post 1e-4 relative, every accept decision and count equal, log_step
    within float32 rounding."""
    torch.testing.assert_close(got[draw], want[draw], rtol=1e-4, atol=1e-5)
    assert torch.equal(got["accept"], want["accept"]) and torch.equal(got["accept_total"], want["accept_total"])
    torch.testing.assert_close(got["log_step"], want["log_step"], rtol=1e-5, atol=1e-6)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))


@pytest.mark.parametrize("p,variant", [(1, "plain"), (5, "truncated"), (32, "truncated_adapting"),
                                       (12, "adapting")],
                         ids=["p1_plain", "p5_truncated", "p32_truncated_adapting", "p12_adapting"])
def test_random_walk_kernel_matches_plain(dev, p, variant):
    """K7 against its plain version on the same Philox bits: 300 chains (ragged
    against the 32-thread blocks), n_burn 6, n_keep 5, n_thin 2, unrolled
    (p <= 8) and looped (p > 8) instantiations, both proposal variants."""
    from openmcmc_tpu_torch.fused import random_walk as rw

    rng = np.random.default_rng(p)
    box = (np.full(p, -1.0), np.full(p, 1.5)) if variant.startswith("truncated") else None
    scal, kw = rw.prepare(rng.normal(0.5, 1.0, (p, 8)), mu=0.1 * rng.normal(size=p), tau=rng.uniform(0.5, 2.0, p),
                          lam=rng.uniform(0.5, 2.0, p), step=rng.uniform(0.2, 0.8, p), h0=0.1 * rng.normal(size=p),
                          domain=box, device=dev)
    kw.update(adapt=variant.endswith("adapting"), target=0.3, rate=0.1, n_burn=6, n_keep=5, n_thin=2)
    before = rw.rw_sweeps_kernel.launches
    got = rw.rw_sweeps(7, scal, 300, **kw)
    want = rw.rw_sweeps_plain(7, scal, 300, **kw)
    torch.cuda.synchronize()
    assert rw.rw_sweeps_kernel.launches == before + 1
    assert tuple(got["h"].shape) == (300, 5, p)
    _assert_mh_matches_plain(got, want, "h")
    if box is not None:
        assert float(got["h"].min()) >= -1.0 and float(got["h"].max()) <= 1.5


@pytest.mark.parametrize("p,adapt", [(5, False), (12, True), (16, False)], ids=["p5", "p12_adapting", "p16"])
def test_mmala_kernel_matches_plain(dev, p, adapt):
    """K8 against its plain version on the same Philox bits: 300 chains, n_burn
    6, n_keep 5, n_thin 2; the unrolled (p <= 8) and looped instantiations."""
    from openmcmc_tpu_torch.fused import mmala

    X, y, extra = _linreg_problem(dev, 60, p, p)
    prep = mmala.prepare(X, y, tau=1.5, lam=0.7, ptau_diag=extra["ptau_diag"], plam_diag=extra["plam_diag"],
                         mu0=extra["mu"])
    scal = torch.from_numpy(prep["scal"]).to(dev)
    kw = dict(p=p, n_obs=60.0, step=0.6, adapt=adapt, target=0.5, rate=0.1, n_burn=6, n_keep=5, n_thin=2)
    before = mmala.mmala_sweeps_kernel.launches
    got = mmala.mmala_sweeps(4, scal, 300, **kw)
    want = mmala.mmala_sweeps_plain(4, scal, 300, **kw)
    torch.cuda.synchronize()
    assert mmala.mmala_sweeps_kernel.launches == before + 1
    assert tuple(got["beta"].shape) == (300, 5, p)
    _assert_mh_matches_plain(got, want, "beta")


@pytest.mark.parametrize("N,p,adapt", [(80, 24, True), (600, 250, False)], ids=["p24_smem_adapting", "p250_global"])
def test_spectral_mmala_kernel_matches_plain(dev, N, p, adapt):
    """K9 against its plain version on the same Philox bits: 100 chains, n_burn
    4, n_keep 5, n_thin 2; V in shared memory at p = 24, in global memory at the
    ragged p = 250 (eight 32-row sum windows)."""
    from openmcmc_tpu_torch.fused import spectral

    X, y, extra = _linreg_problem(dev, N, p, p)
    prep = spectral.prepare_mmala(X, y, tau=1.5, lam=0.7, ptau_diag=extra["ptau_diag"],
                                  plam_diag=extra["plam_diag"], mu0=extra["mu"])
    tensors, kw = spectral.mmala_inputs(prep, dev)
    kw.update(step=0.5, adapt=adapt, target=0.5, rate=0.1, n_burn=4, n_keep=5, n_thin=2)
    before = spectral.spectral_mmala_sweeps_kernel.launches
    got = spectral.spectral_mmala_sweeps(3, *tensors, 100, **kw)
    want = spectral.spectral_mmala_sweeps_plain(3, *tensors, 100, **kw)
    torch.cuda.synchronize()
    assert spectral.spectral_mmala_sweeps_kernel.launches == before + 1
    assert tuple(got["beta"].shape) == (100, 5, p)
    _assert_mh_matches_plain(got, want, "beta")


def test_gamma_elem_kernel_matches_plain(dev):
    """K2's gamma_mt_elem, launched alone over 4096 counter rows, against its
    plain version on the same Philox sites: elementwise shapes in [1, 200),
    every value within 1e-6 relative."""
    from openmcmc_tpu_torch.fused import prng

    gen = torch.Generator().manual_seed(1)
    ctr = torch.randint(0, 2**20, (4096, 4), dtype=torch.int32, generator=gen).to(dev)
    a = (1.0 + 199.0 * torch.rand((4096, 4), generator=gen)).to(dev)
    rate = (0.1 + 3.0 * torch.rand((4096, 4), generator=gen)).to(dev)
    before = prng.gamma_elem_draws.launches
    got = prng.gamma_elem_draws(11, ctr, a, rate)
    want = prng.gamma_elem_draws_plain(11, ctr, a, rate)
    torch.cuda.synchronize()
    assert prng.gamma_elem_draws.launches == before + 1
    assert bool(torch.all(torch.isfinite(got))) and bool(torch.all(got > 0))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("k,n,conjugate,box", [(2, 200, False, True), (2, 2100, True, False), (16, 3000, True, False),
                                               (16, 2500, False, True), (5, 37, False, False)],
                         ids=["k2_n200_rw_box", "k2_n2100_conjugate", "k16_n3000_conjugate", "k16_n2500_rw_box",
                              "k5_n37_rw"])
def test_mixture_kernel_matches_plain(dev, k, n, conjugate, box):
    """K10 against its plain version on the same Philox bits: 64 chains, n_burn
    3, n_keep 4, n_thin 2, Z stored; both variants, K = 2, 5 and 16, n from 37
    (a ragged group of four) past 2048. Every allocation equal; means, lams
    rtol 1e-4, atol 1e-5; log_post 1e-4 relative; the accept counts equal."""
    from openmcmc_tpu_torch.fused import mixture

    rng = np.random.default_rng(k + n)
    alloc = rng.integers(0, k, n)
    y = np.linspace(-3.0, 3.0, k)[alloc] + rng.normal(0.0, 0.5, n)
    prior = rng.uniform(0.2, 1.0, (n, k))
    domain = (np.full(k, -4.0), np.full(k, 4.0)) if box else None
    scal, data, kw = mixture.prepare(y, prior, 0.0, 0.01, 2.0, 1.0, np.linspace(-1.0, 1.0, k), np.ones(k),
                                     domain=domain, device=dev)
    kw.update(conjugate=conjugate, step=0.3, n_burn=3, n_keep=4, n_thin=2, store_z=True)
    before = mixture.mixture_sweeps_kernel.launches
    got = mixture.mixture_sweeps(5, scal, data, 64, **kw)
    want = mixture.mixture_sweeps_plain(5, scal, data, 64, **kw)
    torch.cuda.synchronize()
    assert mixture.mixture_sweeps_kernel.launches == before + 1
    assert tuple(got["z"].shape) == (64, 4, n) and got["z"].dtype == torch.int32
    assert torch.equal(got["z"], want["z"])
    for name in ("means", "lams"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-5)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))
    assert torch.equal(got["accept_total"], want["accept_total"])
