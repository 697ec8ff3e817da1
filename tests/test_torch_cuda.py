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


def profiling_count(name: str) -> int:
    """The tracer's counter ``name`` so far."""
    from openmcmc_tpu_torch.utils import profiling

    return profiling.counters().get(name, 0)


def launches(kernel: str) -> int:
    """The launches of ``kernel`` so far (the tracer's ``launch.<kernel>`` counter)."""
    return profiling_count(f"launch.{kernel}")


@pytest.mark.parametrize("a1,a2", [(60.0, 51.0), (2.5, 0.5)])
def test_prng_draws_kernel_matches_plain(dev, a1, a2):
    from openmcmc_tpu_torch.fused import prng

    ctr = torch.randint(0, 2**31 - 1, (4096, 4), dtype=torch.int32, generator=torch.Generator().manual_seed(0))
    ctr = ctr.to(dev)
    before = launches("prng_draws")
    got = prng.draws(5, ctr, a1, a2, 2.0, 0.5)
    want = prng.draws_plain(5, ctr, a1, a2, 2.0, 0.5)
    torch.cuda.synchronize()
    assert launches("prng_draws") == before + 1
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def store_routes() -> tuple:
    """The store kernel's launches and the K1 launches routed to it, so far."""
    return launches("spectral_store"), profiling_count("spectral_smoother.store_kernel")


@pytest.mark.parametrize(
    "p,n_chains,n_thin,a_lam",
    [(1, 64, 1, 0.2), (12, 40, 1, 2.0), (100, 96, 2, 2.0), (300, 16, 2, 2.0), (128, 40, 1, 2.0),
     (129, 40, 2, 2.0)],
    ids=["p1_shape_below_1", "p12", "p100_smem", "p300_global", "p128_narrow_tile", "p129_wide_tile"],
)
def test_spectral_kernel_matches_plain(dev, p, n_chains, n_thin, a_lam):
    """K1 against its plain version. Up to p = 256 K1 writes w and the store
    kernel makes b = V w (128-column tile to p = 128, 256 above: one launch and
    one ``spectral_smoother.store_kernel`` count a call); at p = 300 K1 stores
    b itself and the store kernel does not run."""
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
    before, routes = launches("spectral_smoother"), store_routes()
    got = spectral.smoother_sweeps(9, *args, **kw)
    want = spectral.smoother_sweeps_plain(9, *args, **kw)
    torch.cuda.synchronize()
    assert launches("spectral_smoother") == before + 1
    routed = int(p <= 256)
    assert store_routes() == (routes[0] + routed, routes[1] + routed)
    for name in ("b", "lam", "tau"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-5)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))


def _warm_rows(dev, n_chains, seed):
    """Per-chain (lam, tau) rows that differ from chain to chain, as a resume's."""
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    return torch.as_tensor(rng.uniform(1.0, 30.0, n_chains), **f32), torch.as_tensor(rng.uniform(0.3, 3.0, n_chains),
                                                                                     **f32)


def test_spectral_kernel_warm_rows_match_plain(dev):
    """K1 started from per-chain (lam, tau) rows, as a resume starts it (no
    burn-in), against its plain version: p 100, 96 chains, n_keep 5."""
    from openmcmc_tpu_torch.fused import spectral

    p, n_chains = 100, 96
    rng = np.random.default_rng(3)
    A = rng.normal(size=(p, p))
    prep = spectral.prepare(rng.normal(size=p), A @ A.T / p + 0.1 * np.eye(p), noise_diag=rng.uniform(0.5, 2.0, p),
                            mu0=rng.normal(size=p))
    args = [torch.as_tensor(prep[k], dtype=torch.float32, device=dev).contiguous() for k in ("V", "s", "wy", "wmu")]
    args += _warm_rows(dev, n_chains, 4)
    kw = dict(logdet_p0=prep["logdet_p0"], logdet_d=prep["logdet_d"], a_lam=2.0, b_lam=1.0, a_tau=2.0, b_tau=1.0,
              n_burn=0, n_keep=5, n_thin=1)
    got = spectral.smoother_sweeps(9, *args, **kw)
    want = spectral.smoother_sweeps_plain(9, *args, **kw)
    torch.cuda.synchronize()
    for name in ("b", "lam", "tau"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-5)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))


def test_spectral_resume_through_store_kernel_matches_plain(dev, monkeypatch):
    """A p = 100 smoother resumed by ``MCMC.run(resume=...)`` with n_thin 3: the
    resume's K1 call, made from per-chain warm rows with no burn-in, writes w
    and the store kernel turns it into b (one launch of each), and K1 run again
    on the call's own arguments agrees with its plain version."""
    from openmcmc_tpu_torch.fused import spectral
    from torch_models import smoother_mcmc

    mcmc = smoother_mcmc(5, p=100, n_chains=96, n_burn=6, n_iter=4, device=dev)
    mcmc.n_thin = 3
    first = mcmc.run(engine="auto")
    real, calls = spectral.smoother_sweeps, []

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(spectral, "smoother_sweeps", spy)
    before, routes = launches("spectral_smoother"), store_routes()
    res = mcmc.run(engine="auto", resume=first)
    torch.cuda.synchronize()
    assert first.engine == res.engine == "fused_smoother_spectral" and len(calls) == 1
    assert launches("spectral_smoother") == before + 1 and store_routes() == (routes[0] + 1, routes[1] + 1)
    args, kw = calls[0]
    assert kw["n_burn"] == 0 and kw["n_thin"] == 3 and kw["n_keep"] == 4
    lam0 = args[5]
    assert torch.unique(lam0).numel() > 0.9 * lam0.numel(), "the resume's rows are not per chain"
    kw = {k: v for k, v in kw.items() if k != "bit_source"}
    got = spectral.smoother_sweeps_kernel(*args, **kw)
    want = spectral.smoother_sweeps_plain(*args, **kw)
    torch.cuda.synchronize()
    for name in ("b", "lam", "tau"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-5)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))
    b = res.store["b"]
    assert tuple(b.shape) == (96, 4, 100, 1) and bool(torch.all(torch.isfinite(b)))


def test_cuda_path_refuses_injected_bits(dev):
    from openmcmc_tpu_torch.fused import spectral

    V = torch.eye(3, device=dev)
    v = torch.ones(3, device=dev)
    c = torch.ones(2, device=dev)
    with pytest.raises(ValueError, match="CPU only"):
        spectral.smoother_sweeps(0, V, v, v, v, c, c, bit_source=lambda *a: None, logdet_p0=0.0,
                                 logdet_d=0.0, a_lam=1.0, b_lam=1.0, a_tau=1.0, b_tau=1.0, n_burn=0, n_keep=1)


def _tridiag_inputs(dev, n_chains, p, seed):
    """Per-chain diagonally dominant tridiagonal Q = (a, c) and b on the card."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (n_chains, p))
    c[:, -1] = 0.0
    a = 2.5 + rng.uniform(0.0, 3.0, (n_chains, p))
    b = rng.normal(size=(n_chains, p))
    return [torch.as_tensor(t, dtype=torch.float32, device=dev) for t in (a, c, b)]


@pytest.mark.parametrize("n_chains,p", [(8192, 100), (1000, 4099), (37, 300), (64, 4096)],
                         ids=["main_path", "ragged", "three_tiles", "global_scratch"])
def test_tridiag_kernel_matches_plain(dev, n_chains, p):
    """K3 against its plain version on the same Philox bits; rtol 1e-4, atol 1e-5.
    (37, 300) is ragged against the 32-chain blocks and spans three tiles (one
    through the global scratch); (64, 4096) sends 30 tiles through it."""
    from openmcmc_tpu_torch.linalg import tridiag

    a, c, b = _tridiag_inputs(dev, n_chains, p, seed=p)
    before = launches("tridiag_canonical")
    got = tridiag.sample_canonical_tridiag(3, 41, a, c, b)
    want = tridiag.sample_canonical_tridiag_plain(3, 41, a, c, b)
    torch.cuda.synchronize()
    assert launches("tridiag_canonical") == before + 1
    assert got.shape == (n_chains, p) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_tridiag_kernel_reads_band_rows_in_place(dev):
    """K3 on the band rows of a (B, 2, p) Banded, row stride 2p, and a b with row
    stride p + 3: the same draw as on contiguous copies, bit for bit, and the
    plain version's within rtol 1e-4, atol 1e-5 (B = 45, p = 301)."""
    from openmcmc_tpu_torch.linalg import tridiag

    n_chains, p = 45, 301
    a, c, b = _tridiag_inputs(dev, n_chains, p, seed=5)
    bands = torch.stack([a, c], dim=1)
    wide_b = torch.zeros((n_chains, p + 3), dtype=torch.float32, device=dev)
    wide_b[:, 2 : p + 2] = b
    av, cv, bv = bands[:, 0, :], bands[:, 1, :], wide_b[:, 2 : p + 2]
    assert av.stride() == (2 * p, 1) and cv.stride() == (2 * p, 1) and bv.stride() == (p + 3, 1)
    assert tridiag._rows(cv).data_ptr() == cv.data_ptr()
    got = tridiag.sample_canonical_tridiag(9, 4, av, cv, bv)
    copies = tridiag.sample_canonical_tridiag(9, 4, a, c, b)
    want = tridiag.sample_canonical_tridiag_plain(9, 4, a, c, b)
    torch.cuda.synchronize()
    assert torch.equal(got, copies)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _tridiag_forward(a, c, b):
    """One chain's forward recurrences in float32 as the plain version runs them:
    l_i = c_{i-1} / ld_{i-1}, ld_i, w_i per row."""
    ld_prev, w_prev = torch.tensor(1.0), torch.tensor(0.0)
    ls, lds, ws = [], [], []
    for i in range(a.shape[0]):
        l_prev = (c[i - 1] if i else torch.tensor(0.0)) / ld_prev
        ld = torch.sqrt(a[i] - l_prev * l_prev)
        w = (b[i] - l_prev * w_prev) / ld
        ls.append(l_prev)
        lds.append(ld)
        ws.append(w)
        ld_prev, w_prev = ld, w
    return torch.stack(ls), torch.stack(lds), torch.stack(ws)


def test_tridiag_exact_redo_matches_plain(dev):
    """K3 where its certificates fail: b at 1e-16 puts |ld w| below the certified
    range, so every block reruns both passes with the IEEE operators; the draw
    equals the plain version's bit for bit (100 chains, p 300: three tiles, one
    through the global scratch). The precondition is checked first: chain 0's
    forward divisions (l = c / ld_prev, w = (b - l w_prev) / ld) hold some
    divisor outside [2^-30, 2^30] or some |divisor x quotient| outside
    [2^-40, 2^40], the ranges ``div_certified`` accepts."""
    from openmcmc_tpu_torch.linalg import tridiag

    a, c, b = _tridiag_inputs(dev, 100, 300, seed=300)
    b = b * 1e-16
    l, ld, w = _tridiag_forward(a[0].cpu(), c[0].cpu(), b[0].cpu())
    divisor = torch.cat([torch.cat([torch.ones(1), ld[:-1]]), ld])
    bq = torch.abs(divisor * torch.cat([l, w]))[1:]  # row 0's l is not a division
    divisor = torch.abs(divisor)[1:]
    outside = (divisor < 2**-30) | (divisor > 2**30) | (bq < 2**-40) | (bq > 2**40)
    assert bool(outside.any()), "the inputs no longer force the IEEE rerun"
    got = tridiag.sample_canonical_tridiag(11, 6, a, c, b)
    want = tridiag.sample_canonical_tridiag_plain(11, 6, a, c, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


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
    before = launches("tridiag_canonical")
    res = mcmc.run()
    torch.cuda.synchronize()
    assert res.engine == "generic"
    assert launches("tridiag_canonical") == before + 16
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
    before = launches("truncnorm_draws")
    got = prng.truncnorm_draws(3, ctr.to(dev), *args)
    want = prng.truncnorm_draws_plain(3, ctr.to(dev), *args)
    torch.cuda.synchronize()
    assert launches("truncnorm_draws") == before + 1
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


@pytest.mark.parametrize("truncated,n_chains,p", [
    (False, 64, 12), (True, 64, 12), (False, 1000, 1031), (True, 1000, 1031), (False, 1000, 4096),
    (False, 1000, 4099), (True, 4096, 100), (True, 64, 6200),
], ids=["small-thomas", "small-truncated", "ragged-thomas", "ragged-truncated", "p4096-thomas", "p4099-thomas",
        "p100_4096chains-truncated", "p6200_global-truncated"])
def test_gmrf_smoother_kernel_matches_plain(dev, truncated, n_chains, p):
    """K4 against its plain version on the same Philox bits, n_burn 3, n_keep 4,
    n_thin 2; b, lam, tau rtol 1e-4 atol 1e-5, log_post 1e-4 relative, and
    every value equal bit for bit (1000 chains: not a multiple of a Thomas
    block's 32); every truncated draw in its box. At p = 6200 the truncated
    kernel's carried x (4 p floats a block) is past 96 KB and stays in the
    per-chain global scratch."""
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs

    args, kw = _k4_inputs(dev, n_chains, p, truncated)
    kw.update(n_burn=3, n_keep=4, n_thin=2)
    before = launches("gmrf_smoother")
    got = gs.gmrf_smoother(13, *args, **kw)
    want = gs.gmrf_smoother_plain(13, *args, **kw)
    torch.cuda.synchronize()
    assert launches("gmrf_smoother") == before + 1
    for name in ("b", "lam", "tau"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-5)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))
    if truncated:
        assert bool(torch.all((got["b"] >= kw["lo"]) & (got["b"] <= kw["hi"])))
    for name in ("b", "lam", "tau", "log_post"):
        assert torch.equal(got[name], want[name]), name


def _thomas_forward(p0d, p0c, y, d, p0mu, lam, tau):
    """The first sweep's forward recurrences of one chain, as the plain version
    runs them in float32: l_i = lam c_{i-1} / ld_{i-1}, ld_i and w_i per row."""
    rhs, qd = tau * (d * y) + lam * p0mu, lam * p0d + tau * d
    ld_prev, w_prev = torch.tensor(1.0), torch.tensor(0.0)
    ls, lds, ws = [], [], []
    for i in range(y.shape[0]):
        l_prev = (lam * p0c[i - 1] if i else torch.tensor(0.0)) / ld_prev
        ld = torch.sqrt(qd[i] - l_prev * l_prev)
        w = (rhs[i] - l_prev * w_prev) / ld
        ls.append(l_prev)
        lds.append(ld)
        ws.append(w)
        ld_prev, w_prev = ld, w
    return torch.stack(ls), torch.stack(lds), torch.stack(ws)


def test_gmrf_smoother_exact_redo_matches_plain(dev):
    """K4's Thomas variant where its certificates fail: y at 1e-16 puts the
    forward quotients' |b q| below the certified range, so every sweep's passes
    rerun with the IEEE operators; the values still equal the plain version's
    bit for bit (1000 chains, p 300). The precondition is checked first: the
    first sweep's forward divisions (l = lam c / ld_prev, w = (rhs - l w_prev) / ld)
    hold some divisor outside [2^-30, 2^30] or some |divisor x quotient|
    outside [2^-40, 2^40], the ranges ``div_certified`` accepts."""
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs

    args, kw = _k4_inputs(dev, 1000, 300, False)
    args[2] = args[2] * 1e-16
    args[4] = torch.zeros_like(args[4])
    args[5] = torch.zeros_like(args[5])
    kw.update(n_burn=3, n_keep=4, n_thin=2)
    p0d, p0c, y, d, _, p0mu = (t.cpu() for t in args[:6])
    l, ld, w = _thomas_forward(p0d, p0c, y, d, p0mu, args[6][0].cpu(), args[7][0].cpu())
    divisor = torch.cat([torch.cat([torch.ones(1), ld[:-1]]), ld])
    bq = torch.abs(divisor * torch.cat([l, w]))[1:]  # row 0's l is not a division
    divisor = torch.abs(divisor)[1:]
    outside = (divisor < 2**-30) | (divisor > 2**30) | (bq < 2**-40) | (bq > 2**40)
    assert bool(outside.any()), "the inputs no longer force the IEEE rerun"
    got = gs.gmrf_smoother(13, *args, **kw)
    want = gs.gmrf_smoother_plain(13, *args, **kw)
    torch.cuda.synchronize()
    for name in ("b", "lam", "tau", "log_post"):
        assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("truncated", [False, True], ids=["thomas", "truncated"])
def test_gmrf_smoother_kernel_warm_rows_match_plain(dev, truncated):
    """K4 started from per-chain (lam, tau) rows and, truncated, a per-chain
    latent inside the box, as a resume starts it (no burn-in), against its plain
    version: p 1031, 300 chains, n_keep 4."""
    from openmcmc_tpu_torch.fused import gmrf_smoother as gs

    n_chains, p = 300, 1031
    args, kw = _k4_inputs(dev, n_chains, p, truncated)
    args[6:8] = _warm_rows(dev, n_chains, 5)
    if truncated:
        u = torch.rand((n_chains, p), generator=torch.Generator().manual_seed(6)).to(dev)
        kw["b_init"] = (kw["lo"] + u * (kw["hi"] - kw["lo"])).contiguous()
    kw.update(n_burn=0, n_keep=4, n_thin=1)
    got = gs.gmrf_smoother(13, *args, **kw)
    want = gs.gmrf_smoother_plain(13, *args, **kw)
    torch.cuda.synchronize()
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
    before = launches("gmrf_smoother")
    res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    assert res.engine == "fused_gmrf_smoother_truncated"
    assert launches("gmrf_smoother") == before + 1
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


def _linreg_args(dev, p, n_chains, lam0=None, tau0=None, scale_x=1.0):
    """K6's arguments on a 60-row problem (X scaled by ``scale_x``), every chain
    started at (0.5, 1.0) unless per-chain rows are given."""
    from openmcmc_tpu_torch.fused import linreg

    X, y, extra = _linreg_problem(dev, 60, p, p)
    f32 = dict(dtype=torch.float32, device=dev)
    plam = torch.as_tensor(extra["plam_diag"], **f32)
    G, c, scal = linreg.sufficient_statistics(torch.as_tensor(X * scale_x, **f32), torch.as_tensor(y, **f32), plam,
                                              torch.as_tensor(extra["ptau_diag"], **f32))
    if lam0 is None:
        lam0, tau0 = torch.full((n_chains,), 0.5, **f32), torch.full((n_chains,), 1.0, **f32)
    return [G, c, plam, torch.as_tensor(extra["mu"], **f32), scal, lam0, tau0]


def _linreg_kernel_and_plain(args, kw):
    """K6 and its plain version on the same Philox bits; asserts one launch, on
    the pipelined design."""
    from openmcmc_tpu_torch.fused import linreg

    before = launches("linreg"), profiling_count("linreg.pipelined")
    got = linreg.linreg_sweeps(5, *args, **kw)
    want = linreg.linreg_sweeps_plain(5, *args, **kw)
    torch.cuda.synchronize()
    assert (launches("linreg"), profiling_count("linreg.pipelined")) == (before[0] + 1, before[1] + 1)
    return got, want


@pytest.mark.parametrize("p,a_lam,n_chains,n_burn,n_keep,n_thin", [
    (1, 0.2, 200, 4, 6, 2), (2, 1e-3, 200, 4, 6, 2), (7, 2.0, 200, 4, 6, 2), (16, 2.0, 200, 4, 6, 2),
    (8, 2.0, 200, 4, 6, 2), (9, 2.0, 200, 4, 6, 2), (1, 0.2, 4100, 7, 20, 3), (2, 1e-3, 4100, 7, 20, 3),
    (9, 2.0, 200, 7, 20, 3), (16, 2.0, 4100, 7, 20, 3),
], ids=["p1_shape_below_1", "p2", "p7", "p16", "p8", "p9", "p1_4100_ragged_tile", "p2_4100_ragged_tile",
        "p9_ragged_tile", "p16_4100_ragged_tile"])
def test_linreg_kernel_matches_plain(dev, p, a_lam, n_chains, n_burn, n_keep, n_thin):
    """K6 against its plain version on the same Philox bits: 200 or 4100 chains
    (both ragged against the 32-chain blocks); n_burn 4, n_keep 6, n_thin 2, or
    67 sweeps (n_burn 7, n_keep 20, n_thin 3), which end in a ragged tile at
    every tile depth and store across tile edges; beta, lam, tau rtol 1e-4
    atol 1e-5, log_post 1e-4 relative."""
    args = _linreg_args(dev, p, n_chains)
    kw = dict(n_obs=60.0, a_lam=a_lam, b_lam=1.0, a_tau=2.0, b_tau=1.0, n_burn=n_burn, n_keep=n_keep, n_thin=n_thin)
    got, want = _linreg_kernel_and_plain(args, kw)
    assert tuple(got["beta"].shape) == (n_chains, n_keep, p)
    _assert_kernel_matches_plain(got, want)


@pytest.mark.parametrize("p,n_keep,n_thin", [(7, 6, 1), (2, 50, 3), (16, 30, 1)], ids=["p7", "p2_thin3", "p16"])
def test_linreg_kernel_warm_rows_match_plain(dev, p, n_keep, n_thin):
    """K6 started from per-chain (lam, tau) rows, as a resume starts it (no
    burn-in), against its plain version: 200 chains."""
    args = _linreg_args(dev, p, 200, *_warm_rows(dev, 200, 7))
    kw = dict(n_obs=60.0, a_lam=2.0, b_lam=1.0, a_tau=2.0, b_tau=1.0, n_burn=0, n_keep=n_keep, n_thin=n_thin)
    got, want = _linreg_kernel_and_plain(args, kw)
    _assert_kernel_matches_plain(got, want)


@pytest.mark.parametrize("p", [2, 9])
def test_linreg_exact_redo_matches_plain(dev, p):
    """K6 where its certificates fail: X at 1e12 puts L[0][0] = sqrt(lam plam_0
    + tau G_00) above 2^30, the largest root the consumer's certificate
    accepts, so every tile reruns with the IEEE operators; the draws still match the plain version's
    (200 chains, 40 sweeps over several tiles). The precondition is checked
    first, on the starting (lam, tau)."""
    args = _linreg_args(dev, p, 200, scale_x=1e12)
    G, plam, lam0, tau0 = args[0].cpu(), args[2].cpu(), args[5].cpu(), args[6].cpu()
    assert float(torch.sqrt(lam0[0] * plam[0] + tau0[0] * G[0, 0])) > 2**30, "the inputs no longer force the rerun"
    kw = dict(n_obs=60.0, a_lam=2.0, b_lam=1.0, a_tau=2.0, b_tau=1.0, n_burn=10, n_keep=30, n_thin=1)
    got, want = _linreg_kernel_and_plain(args, kw)
    _assert_kernel_matches_plain(got, want)


@pytest.mark.parametrize("p", [1, 24, 100, 250, 256, 128, 129])
def test_spectral_store_kernel_matches_plain(dev, p):
    """The store kernel of K1, K5 and K9 alone: 1000 + 37 rows (ragged against
    its 64-row strips) of a larger buffer become rows V' in place, against the
    plain product within float32 summation-order rounding (rtol 1e-5, atol 1e-5
    at O(1) inputs); the 37 rows past them stay untouched. p = 1, 24, 100 and
    128 take the 128-column tile, p = 129, 250 and 256 the 256-column one;
    every p but 128 and 256 masks columns of its tile, and p = 1, 24, 100, 129
    and 250 end in a ragged k-tile (scalar stores where p is not a multiple of
    4)."""
    from openmcmc_tpu_torch.fused import spectral

    rng = np.random.default_rng(p)
    n_rows = 1037
    f32 = dict(dtype=torch.float32, device=dev)
    w = torch.as_tensor(rng.normal(size=(n_rows + 37, p)), **f32)
    V = torch.as_tensor(rng.normal(size=(p, p)) / np.sqrt(p), **f32)
    buf = w.clone()
    before = launches("spectral_store")
    out = spectral.spectral_store_kernel(buf[:n_rows], V)
    want = spectral.spectral_store_plain(w[:n_rows], V)
    torch.cuda.synchronize()
    assert launches("spectral_store") == before + 1
    assert out.data_ptr() == buf.data_ptr()
    torch.testing.assert_close(buf[:n_rows], want, rtol=1e-5, atol=1e-5)
    assert torch.equal(buf[n_rows:], w[n_rows:])


def _assert_store_launched(kernel, before):
    """One launch of the sweep kernel and one of the store kernel since ``before``."""
    assert (launches(kernel), launches("spectral_store")) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("N,p", [(80, 24), (600, 250)], ids=["p24", "p250"])
def test_spectral_linreg_kernel_matches_plain(dev, N, p):
    """K5 and its store kernel against the plain version on the same Philox
    bits: 100 chains, n_burn 3, n_keep 5, n_thin 2, at p = 24 and the ragged
    p = 250 (eight 32-row sum windows); lam, tau and log_post bit for bit."""
    from openmcmc_tpu_torch.fused import spectral

    X, y, extra = _linreg_problem(dev, N, p, p)
    prep = spectral.prepare_linreg(X, y, **extra)
    f32 = dict(dtype=torch.float32, device=dev)
    args = [torch.as_tensor(prep[k], **f32).contiguous() for k in ("V", "s", "wmu", "cv")]
    args += [torch.full((100,), 0.5, **f32), torch.full((100,), 1.0, **f32)]
    kw = {k: float(np.float32(prep[k])) for k in ("yPy", "logdet_plam", "logdet_ptau")}
    kw.update(n_obs=float(N), a_lam=2.0, b_lam=1.0, a_tau=2.0, b_tau=1.0, n_burn=3, n_keep=5, n_thin=2)
    before = launches("spectral_linreg"), launches("spectral_store")
    got = spectral.spectral_linreg_sweeps(3, *args, **kw)
    want = spectral.spectral_linreg_sweeps_plain(3, *args, **kw)
    torch.cuda.synchronize()
    _assert_store_launched("spectral_linreg", before)
    assert tuple(got["beta"].shape) == (100, 5, p)
    _assert_kernel_matches_plain(got, want)
    for name in ("lam", "tau", "log_post"):
        assert torch.equal(got[name], want[name]), name


def _assert_mh_matches_plain(got, want, draw):
    """A Metropolis kernel against its plain version: draws rtol 1e-4 atol 1e-5,
    log_post 1e-4 relative, every accept decision and count equal, log_step
    within float32 rounding."""
    torch.testing.assert_close(got[draw], want[draw], rtol=1e-4, atol=1e-5)
    assert torch.equal(got["accept"], want["accept"]) and torch.equal(got["accept_total"], want["accept_total"])
    torch.testing.assert_close(got["log_step"], want["log_step"], rtol=1e-5, atol=1e-6)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))


@pytest.mark.parametrize("p,variant,n_chains", [
    (1, "plain", 300), (5, "truncated", 300), (32, "truncated_adapting", 300), (12, "adapting", 300),
    (2, "truncated_adapting", 37), (3, "truncated_adapting", 37), (17, "truncated_adapting", 37),
    (31, "truncated_adapting", 37),
], ids=["p1_plain", "p5_truncated", "p32_truncated_adapting", "p12_adapting", "p2_truncated_adapting",
        "p3_truncated_adapting", "p17_truncated_adapting", "p31_truncated_adapting"])
def test_random_walk_kernel_matches_plain(dev, p, variant, n_chains):
    """K7 against its plain version on the same Philox bits: n_burn 6, n_keep 5,
    n_thin 2, both proposal variants; 300 or 37 chains, ragged against the
    128-thread blocks, at every lane width W (p rounded up to a power of two):
    p = 1 a chain a lane, p = 2, 3 and 5 several chains a warp with lanes past
    p masked, p = 12 and 17 masked lanes in a half or whole warp, p = 31 and 32
    a warp a chain."""
    from openmcmc_tpu_torch.fused import random_walk as rw

    rng = np.random.default_rng(p)
    box = (np.full(p, -1.0), np.full(p, 1.5)) if variant.startswith("truncated") else None
    scal, kw = rw.prepare(rng.normal(0.5, 1.0, (p, 8)), mu=0.1 * rng.normal(size=p), tau=rng.uniform(0.5, 2.0, p),
                          lam=rng.uniform(0.5, 2.0, p), step=rng.uniform(0.2, 0.8, p), h0=0.1 * rng.normal(size=p),
                          domain=box, device=dev)
    kw.update(adapt=variant.endswith("adapting"), target=0.3, rate=0.1, n_burn=6, n_keep=5, n_thin=2)
    before = launches("random_walk")
    got = rw.rw_sweeps(7, scal, n_chains, **kw)
    want = rw.rw_sweeps_plain(7, scal, n_chains, **kw)
    torch.cuda.synchronize()
    assert launches("random_walk") == before + 1
    assert tuple(got["h"].shape) == (n_chains, 5, p)
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
    before = launches("mmala")
    got = mmala.mmala_sweeps(4, scal, 300, **kw)
    want = mmala.mmala_sweeps_plain(4, scal, 300, **kw)
    torch.cuda.synchronize()
    assert launches("mmala") == before + 1
    assert tuple(got["beta"].shape) == (300, 5, p)
    _assert_mh_matches_plain(got, want, "beta")


@pytest.mark.parametrize("N,p,adapt", [(80, 24, True), (600, 250, False)], ids=["p24_adapting", "p250"])
def test_spectral_mmala_kernel_matches_plain(dev, N, p, adapt):
    """K9 and its store kernel against the plain version on the same Philox
    bits: 100 chains, n_burn 4, n_keep 5, n_thin 2, at p = 24 and the ragged
    p = 250 (eight 32-row sum windows); log_post, every accept decision,
    accept_total and log_step bit for bit."""
    from openmcmc_tpu_torch.fused import spectral

    X, y, extra = _linreg_problem(dev, N, p, p)
    prep = spectral.prepare_mmala(X, y, tau=1.5, lam=0.7, ptau_diag=extra["ptau_diag"],
                                  plam_diag=extra["plam_diag"], mu0=extra["mu"])
    tensors, kw = spectral.mmala_inputs(prep, dev)
    kw.update(step=0.5, adapt=adapt, target=0.5, rate=0.1, n_burn=4, n_keep=5, n_thin=2)
    before = launches("spectral_mmala"), launches("spectral_store")
    got = spectral.spectral_mmala_sweeps(3, *tensors, 100, **kw)
    want = spectral.spectral_mmala_sweeps_plain(3, *tensors, 100, **kw)
    torch.cuda.synchronize()
    _assert_store_launched("spectral_mmala", before)
    assert tuple(got["beta"].shape) == (100, 5, p)
    _assert_mh_matches_plain(got, want, "beta")
    for name in ("log_post", "accept", "accept_total", "log_step"):
        assert torch.equal(got[name], want[name]), name


def test_gamma_elem_kernel_matches_plain(dev):
    """K2's gamma_mt_elem, launched alone over 4096 counter rows, against its
    plain version on the same Philox sites: elementwise shapes in [1, 200),
    every value within 1e-6 relative."""
    from openmcmc_tpu_torch.fused import prng

    gen = torch.Generator().manual_seed(1)
    ctr = torch.randint(0, 2**20, (4096, 4), dtype=torch.int32, generator=gen).to(dev)
    a = (1.0 + 199.0 * torch.rand((4096, 4), generator=gen)).to(dev)
    rate = (0.1 + 3.0 * torch.rand((4096, 4), generator=gen)).to(dev)
    before = launches("gamma_elem_draws")
    got = prng.gamma_elem_draws(11, ctr, a, rate)
    want = prng.gamma_elem_draws_plain(11, ctr, a, rate)
    torch.cuda.synchronize()
    assert launches("gamma_elem_draws") == before + 1
    assert bool(torch.all(torch.isfinite(got))) and bool(torch.all(got > 0))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("k,n,conjugate,box,n_chains", [
    (2, 200, False, True, 64), (2, 2100, True, False, 64), (16, 3000, True, False, 64), (16, 2500, False, True, 64),
    (5, 37, False, False, 64), (16, 100_000, True, False, 37), (2, 200, True, False, 61), (2, 200, False, True, 61),
], ids=["k2_n200_rw_box", "k2_n2100_conjugate", "k16_n3000_conjugate", "k16_n2500_rw_box", "k5_n37_rw",
        "k16_n100000_conjugate_37chains", "k2_n200_conjugate_61chains", "k2_n200_rw_box_61chains"])
def test_mixture_kernel_matches_plain(dev, k, n, conjugate, box, n_chains):
    """K10 against its plain version on the same Philox bits: n_burn 3, n_keep
    4, n_thin 2, Z stored; both variants, K = 2, 5 and 16, n from 37 (a ragged
    group of four) past 2048 to 100,000, 64 chains or a count that is not a
    multiple of a block's four warp-chains. Every allocation equal; means, lams
    rtol 1e-4, atol 1e-5; log_post 1e-4 relative; the accept counts equal; and
    every value equal bit for bit."""
    from openmcmc_tpu_torch.fused import mixture

    rng = np.random.default_rng(k + n)
    alloc = rng.integers(0, k, n)
    y = np.linspace(-3.0, 3.0, k)[alloc] + rng.normal(0.0, 0.5, n)
    prior = rng.uniform(0.2, 1.0, (n, k))
    domain = (np.full(k, -4.0), np.full(k, 4.0)) if box else None
    scal, data, kw = mixture.prepare(y, prior, 0.0, 0.01, 2.0, 1.0, np.linspace(-1.0, 1.0, k), np.ones(k),
                                     domain=domain, device=dev)
    kw.update(conjugate=conjugate, step=0.3, n_burn=3, n_keep=4, n_thin=2, store_z=True)
    before = launches("mixture")
    got = mixture.mixture_sweeps(5, scal, data, n_chains, **kw)
    want = mixture.mixture_sweeps_plain(5, scal, data, n_chains, **kw)
    torch.cuda.synchronize()
    assert launches("mixture") == before + 1
    assert tuple(got["z"].shape) == (n_chains, 4, n) and got["z"].dtype == torch.int32
    assert torch.equal(got["z"], want["z"])
    for name in ("means", "lams"):
        torch.testing.assert_close(got[name], want[name], rtol=1e-4, atol=1e-5)
    assert torch.all(torch.abs(got["log_post"] - want["log_post"])
                     <= 1e-4 * torch.clamp(torch.abs(want["log_post"]), min=1.0))
    assert torch.equal(got["accept_total"], want["accept_total"])
    for name in ("means", "lams", "log_post"):
        assert torch.equal(got[name], want[name]), name


def test_mixture_kernel_rejects_misaligned_data(dev):
    """K10 reads ``data`` as float4: a contiguous view that starts off a 16-byte
    boundary raises a ValueError before any launch."""
    from openmcmc_tpu_torch.fused import mixture

    rng = np.random.default_rng(0)
    y = rng.normal(size=40)
    scal, data, kw = mixture.prepare(y, rng.uniform(0.2, 1.0, (40, 2)), 0.0, 0.01, 2.0, 1.0, np.array([-1.0, 1.0]),
                                     np.ones(2), device=dev)
    kw.update(conjugate=True, step=0.3, n_burn=1, n_keep=1)
    shifted = torch.empty(data.numel() + 1, dtype=torch.float32, device=dev)[1:].view(data.shape)
    shifted.copy_(data)
    before = launches("mixture")
    with pytest.raises(ValueError, match="16-byte"):
        mixture.mixture_sweeps(5, scal, shifted, 8, **kw)
    assert launches("mixture") == before


def _rj_inputs(dev, lik, p, n_data, n_chains, warm, seed=0):
    """K11's data, initial rows and a prior-recovery or regression
    configuration: per-chain warm rows (random counts, padded entries zero,
    counters already running) or the broadcast start of 3 knots."""
    from openmcmc_tpu_torch.fused import rj

    rng = np.random.default_rng(p * 1000 + n_data)
    X = np.sort(rng.uniform(-10, 10, n_data))
    parts = [X] + ([np.sin(X) + 0.1 * rng.normal(size=n_data)] if lik else [])
    data = torch.as_tensor(np.concatenate(parts), dtype=torch.float32, device=dev)
    if warm:
        k = rng.integers(1, p + 1, n_chains)
        active = np.arange(p)[None, :] < k[:, None]
        rows = rj.init_rows(n_chains, p, rng.normal(size=(n_chains, p)) * active,
                            rng.uniform(-10, 10, (n_chains, p)) * active, rng.uniform(0.5, 2.0, (n_chains, p)) * active,
                            k.astype(np.float32), rng.uniform(0.5, 5.0, n_chains) if lik else None,
                            np.tile([3.0, 7.0, 5.0, 1.0, 9.0, 9.0], (n_chains, 1)), device=dev)
    else:
        k0 = min(3, p)
        th, om, be = np.zeros(p), np.zeros(p), np.zeros(p)
        th[:k0], om[:k0], be[:k0] = rng.uniform(-10, 10, k0), 1.0, 1.0
        rows = rj.init_rows(n_chains, p, be, th, om, float(k0), 1.0 if lik else None, device=dev)
    return data, rows


@pytest.mark.parametrize("lik,p,n_data,n_chains,n_thin,warm", [
    (False, 2, 7, 37, 1, False), (False, 8, 50, 1000, 2, True), (False, 20, 200, 37, 1, False),
    (False, 32, 50, 37, 2, True), (True, 2, 50, 1000, 1, True), (True, 8, 7, 37, 2, False),
    (True, 20, 50, 37, 1, True), (True, 32, 200, 37, 2, False),
    (False, 20, 50, 2048, 1, True), (True, 20, 50, 2048, 1, True), (True, 32, 1000, 37, 1, True),
], ids=["null_p2_n7", "null_p8_n50_warm", "null_p20_n200", "null_p32_n50_warm", "lik_p2_n50_warm", "lik_p8_n7",
        "lik_p20_n50_warm", "lik_p32_n200", "null_full_width_warm", "lik_full_width_warm", "lik_p32_n1000_warm"])
def test_rj_kernel_matches_plain(dev, lik, p, n_data, n_chains, n_thin, warm):
    """K11 against its plain version on the same Philox bits, parameters
    streamed: both variants, n_max 2 to 32 (a full warp), n_data 7 to 1000,
    37 to 2048 chains, n_thin 1 and 2, broadcast and per-chain warm initial
    rows, n_burn 2, n_keep 3. The full-width cases (n_max 20, n_data 50, 2048
    chains, warm counts spread over 1..20) give the kernel's active-size loops
    every count, k = n_max (no birth) and k = 1 (no death) included.
    The kernel adds every sum in the plain version's order and rounds like it
    (--fmad=false), so every stored row is equal: the counts, counters and
    accepts, and the values bit for bit."""
    from openmcmc_tpu_torch.fused import rj

    data, rows = _rj_inputs(dev, lik, p, n_data, n_chains, warm)
    config = rj.make_config(p, n_data, rho=min(8.0, p / 2 + 0.5), likelihood=lik, a_tau=2.0, b_tau=0.1,
                            stream=True, n_burn=2, n_keep=3, n_thin=n_thin, seed=11, n_chains=n_chains)
    before = launches("rj")
    got = rj.rj_sweeps(data, rows, n_chains, config=config)
    want = rj.rj_sweeps_plain(data, rows, n_chains, config=config)
    torch.cuda.synchronize()
    assert launches("rj") == before + 1
    assert tuple(got.shape) == (n_chains, 3, 8 + int(lik) + 3 * p) and bool(torch.isfinite(got).all())
    assert torch.equal(got[:, :, :8], want[:, :, :8])  # k, log_post, the six counters
    assert torch.equal(got, want)
    k = got[:, :, 0]
    assert float(k.min()) >= 1.0 and float(k.max()) <= p


def test_rj_auto_run_launches_k11_once(dev):
    """MCMC.run(engine="auto") on the card runs the regression through one K11
    launch, the count stored as int32 on the card."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.basis import GaussianKernelBasis
    from openmcmc_tpu_torch.distributions import Gamma, Normal, Poisson, Uniform
    from openmcmc_tpu_torch.fused import rj
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import LinearCombination, MixtureParameterMatrix, MixtureParameterVector, ScaledMatrix
    from openmcmc_tpu_torch.samplers import ManifoldMALA, NormalGamma, RandomWalkLoop, ReversibleJump

    g, n_max, rng = GaussianKernelBasis(), 8, np.random.default_rng(0)
    X = np.sort(rng.uniform(-10, 10, (30, 1)), axis=0)
    theta = np.zeros((1, n_max)); theta[0, :3] = [-5.0, 0.0, 5.0]
    omega = np.zeros((1, n_max)); omega[0, :3] = 1.0
    state = {"X": X, "y": np.sin(X), "n_basis": np.array([[3]], np.int32), "theta": theta, "omega": omega,
             "beta": np.where(np.arange(n_max)[:, None] < 3, 1.0, 0.0), "alloc_beta": np.zeros((n_max, 1), np.int32),
             "mu_beta": 0.0, "tau_beta": 0.25, "rho": 3.0, "a_omega": 3.0, "b_omega": 2.0,
             "P": st.Diagonal(torch.ones(30)), "tau_y": 1.0, "a_tau": 2.0, "b_tau": 0.1,
             "B": g.make(X, theta, omega, 3).numpy()}
    mdl = Model([
        Normal("y", mean=LinearCombination(form={"beta": "B"}), precision=ScaledMatrix("P", "tau_y")),
        Normal("beta", mean=MixtureParameterVector("mu_beta", "alloc_beta"),
               precision=MixtureParameterMatrix("tau_beta", "alloc_beta"), n_active="n_basis"),
        Poisson("n_basis", rate="rho"),
        Uniform("theta", domain_response_lower=-10.0, domain_response_upper=10.0, n_active="n_basis"),
        Gamma("omega", shape="a_omega", rate="b_omega", n_active="n_basis"),
        Gamma("tau_y", shape="a_tau", rate="b_tau"),
    ])
    walk = dict(state_update_function=g.move, vector_state_update_function=g.move_vec, active_count="n_basis")
    samplers = [
        ManifoldMALA("beta", mdl, step=0.5, active_count="n_basis"),
        RandomWalkLoop("theta", mdl, step=0.1, domain_limits=np.asarray([[-10.0, 10.0]]), updated_names=["theta", "B"],
                       **walk),
        RandomWalkLoop("omega", mdl, step=0.1, domain_limits=np.asarray([[0.5, 2.0]]), updated_names=["omega", "B"],
                       **walk),
        ReversibleJump("n_basis", mdl, associated_params=["theta", "omega"], n_max=n_max, state_birth_function=g.birth,
                       state_death_function=g.death,
                       matching_params={"variable": "beta", "matrix": "B", "scale": 1.0, "limits": [-10.0, 10.0]}),
        NormalGamma("tau_y", mdl),
    ]
    m = MCMC(state, samplers, mdl, n_burn=20, n_iter=50, n_chains=256, seed=1, store_names=["n_basis", "tau_y"],
             device=dev)
    before = launches("rj")
    res = m.run(engine="auto")
    torch.cuda.synchronize()
    assert res.engine == "fused_rj" and launches("rj") == before + 1
    assert res.store["n_basis"].dtype == torch.int32 and res.store["n_basis"].device.type == "cuda"
    assert res.store["tau_y"].shape == (256, 50, 1, 1) and bool(torch.all(res.store["tau_y"] > 0.0))


@pytest.mark.parametrize("shape,shapes", [
    ((1,), (0.3, 0.5, 1.0, 2.5, 10.0, 50.5, 500.0)), ((4099,), (0.3, 0.5, 1.0, 2.5, 10.0, 50.5, 500.0)),
    ((257, 1024), (0.3, 0.5, 1.0, 2.5, 10.0, 50.5, 500.0)), ((1 << 20,), (0.01, 0.3, 1.0)),
], ids=["one", "ragged", "2d", "past_round_0"])
def test_gamma_kernel_matches_plain(dev, shape, shapes):
    """K12 against its plain version on the same Philox bits, the shapes
    tiled over any shape; one launch. ``past_round_0`` tiles {0.01, 0.3, 1}
    over 2^20 draws, boosted shapes near 1 that accept round 0 least often, so
    that many draws go through the kernel's queue of later rounds; a Gamma(0.01)
    draw, u^100 times a Gamma(1.01) one, may underflow to 0 in float32. Every
    value is equal."""
    from openmcmc_tpu_torch.linalg import gamma

    n = int(np.prod(shape))
    a = torch.tensor(shapes).repeat(n // len(shapes) + 1)[:n].reshape(shape).to(dev)
    before = launches("gamma")
    got = gamma.gamma(3, a)
    want = gamma.gamma_plain(3, a)
    torch.cuda.synchronize()
    assert launches("gamma") == before + 1
    assert got.shape == a.shape and bool(torch.all(got > 0) if min(shapes) >= 0.3 else torch.all(got >= 0))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got, want)
    if shape == (1 << 20,):
        assert int((gamma.gamma_rounds(3, a) > 1).sum()) > 10_000


def _cell_mcmc(dev, config):
    """The MCMC of a benchmark configuration's model at its sizes (reference
    example 4's smoother over 100 points with 8192 chains, example 3's
    regression on 100 observations with 4096, the reversible-jump regression
    on 50 points with n_max 20 and 2048 chains, 100 + 200 sweeps), warmed up:
    its match, the eigenbasis and the kernel library are cached."""
    from torch_models import linreg_mcmc, rj_regression_mcmc, smoother_mcmc

    if config == "smoother_ex4":
        mcmc = smoother_mcmc(7, p=100, n_chains=8192, n_burn=200, n_iter=500, device=dev)
    elif config == "rj_regression":
        mcmc, _ = rj_regression_mcmc(7, n_max=20, n_data=50, n_chains=2048, n_burn=100, n_iter=200, device=dev)
    else:
        mcmc = linreg_mcmc(7, n=100, n_chains=4096, n_burn=1000, n_iter=1000, device=dev)
    mcmc.run(engine="auto")
    torch.cuda.synchronize()
    return mcmc


@pytest.mark.parametrize("config", ["smoother_ex4", "linreg_ex3", "rj_regression"])
def test_counted_uploads_are_the_profilers_copies(dev, config):
    """Per fit of each benchmark configuration's model, the tracer's ``h2d.copies``
    (and no other host-to-device copy) is what the profiler sees: its count of
    ``Memcpy HtoD`` events over five fits."""
    from torch.profiler import ProfilerActivity, profile

    from openmcmc_tpu_torch.utils import profiling

    mcmc = _cell_mcmc(dev, config)
    with profiling.record() as rec, profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(5):
            mcmc.seed = 100 + k
            mcmc.run(engine="auto")
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    copies = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda and "Memcpy HtoD" in e.name()]
    per_fit = [counts.get("h2d.copies", 0) for counts in rec.runs.values()]
    assert len(per_fit) == 5 and len(set(per_fit)) == 1 and per_fit[0] > 0
    assert len(copies) == sum(per_fit)


@pytest.mark.parametrize("config", ["smoother_ex4", "linreg_ex3", "rj_regression"])
def test_counted_host_reads_are_the_synchronising_operations(dev, config):
    """Over 20 fits of each benchmark configuration's model, the first a match
    miss (a new run configuration), every synchronising operation that
    ``torch.cuda.set_sync_debug_mode`` reports is a counted read from the card
    (``sync.host_reads``) or a counted pageable upload (``h2d.copies``, which
    waits for the stream)."""
    import warnings

    from openmcmc_tpu_torch.utils import profiling

    mcmc = _cell_mcmc(dev, config)
    mcmc.n_iter += 1  # a new run configuration: the first fit below matches afresh
    matches = len(mcmc._match_cache)
    before = profiling.counters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for k in range(20):
                mcmc.seed = 200 + k
                mcmc.run(engine="auto")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = profiling.counters()
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in ("sync.host_reads", "h2d.copies")}
    syncs = [f"{w.filename}:{w.lineno}" for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    where = {k: syncs.count(k) for k in sorted(set(syncs))}
    assert len(mcmc._match_cache) == matches + 1 and delta["sync.host_reads"] > 0
    assert len(syncs) == delta["sync.host_reads"] + delta["h2d.copies"], (delta, where)


def test_rj_regression_streams_what_k11_writes_and_counts_its_uploads(dev):
    """At the benchmark cell's shape (n_max 20, 50 points, 2048 chains, 3000 +
    5000 sweeps), ``MCMC.run(engine="auto")`` stores exactly what one K11
    launch writes on inputs built without the counted uploads, as the path
    built them before it counted them (``torch.as_tensor`` of the host data and
    rows): k, log_post, tau_y and the streamed beta, theta, omega, bit for bit.
    The fit uploads the data [X | y] and the initial rows, two counted copies
    of 4 (2 n_data + chains (3 n_max + 8)) bytes, and reads nothing back on a
    cached match."""
    from openmcmc_tpu_torch.fused import rj
    from openmcmc_tpu_torch.utils import profiling
    from torch_models import rj_regression_mcmc

    n_max, n_data, chains = 20, 50, 2048
    mcmc, data = rj_regression_mcmc(11, n_max=n_max, n_data=n_data, n_chains=chains, n_burn=3000, n_iter=5000,
                                    device=dev)
    mcmc.run(engine="auto")  # the match, cached
    torch.cuda.synchronize()
    with profiling.record() as rec:
        res = mcmc.run(engine="auto")
    torch.cuda.synchronize()
    assert res.engine == "fused_rj"
    counts = next(iter(rec.runs.values()))
    assert counts.get("h2d.copies") == 2 and counts.get("launch.rj") == 1 and "sync.host_reads" not in counts
    assert counts.get("h2d.bytes") == 4 * (2 * n_data + chains * (3 * n_max + 8))

    init = mcmc.initial_chain_state
    row = np.concatenate([init[name].detach().cpu().numpy().reshape(-1) for name in ("beta", "theta", "omega")]
                         + [[float(init["n_basis"].reshape(())), 100.0], np.zeros(6)]).astype(np.float32)
    rows = torch.as_tensor(np.tile(row, (chains, 1)), device=dev)
    inputs = torch.as_tensor(np.concatenate([data["X"], data["y"]]).astype(np.float32), device=dev)
    # b_tau as the matcher reads it from the card: 0.01 in float32
    config = rj.make_config(n_max, n_data, rho=8.0, a_tau=2.0, b_tau=float(np.float32(0.01)), likelihood=True,
                            stream=True, n_burn=3000, n_keep=5000, seed=mcmc.seed & 0x7FFFFFFF, n_chains=chains)
    want = rj.rj_sweeps_kernel(inputs, rows, chains, config=config)
    torch.cuda.synchronize()
    st = res.store
    assert torch.equal(st["n_basis"][..., 0, 0], want[:, :, 0].to(torch.int32))
    assert torch.equal(res.log_post, want[:, :, 1])
    assert torch.equal(st["tau_y"][..., 0, 0], want[:, :, 8])
    assert torch.equal(st["beta"][..., 0], want[:, :, 9:9 + n_max])
    assert torch.equal(st["theta"][..., 0, :], want[:, :, 9 + n_max:9 + 2 * n_max])
    assert torch.equal(st["omega"][..., 0, :], want[:, :, 9 + 2 * n_max:])
