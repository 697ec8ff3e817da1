"""The canonical tridiagonal draw (openmcmc_tpu_torch.linalg.tridiag, kernel K3's
plain version) against the JAX package's Pallas kernel and a float64 reference.

The JAX kernel runs in interpret mode, whose PRNG stub returns zero bits (see
tests/test_pallas_interpret.py), so the port's plain version is fed all-zero
bits and must give the same x to float32 rounding. With random bits it must
match x = L^-T (L^-1 b + z) evaluated in float64 on the same Box-Muller noise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openmcmc_tpu_torch.fused import prng
from openmcmc_tpu_torch.linalg import gmrf as tgmrf
from openmcmc_tpu_torch.linalg import structured as tst
from openmcmc_tpu_torch.linalg import tridiag

torch.set_num_threads(2)


def random_tridiag(n_chains, p, seed):
    """Per-chain diagonally dominant tridiagonal Q = (a, c) and right-hand sides b,
    float32, with c[:, p-1] = 0 by the band convention."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (n_chains, p)).astype(np.float32)
    c[:, -1] = 0.0
    a = (2.5 + rng.uniform(0.0, 3.0, (n_chains, p))).astype(np.float32)
    b = rng.normal(size=(n_chains, p)).astype(np.float32)
    return a, c, b


def reference_draw(a, c, b, z):
    """float64 x = L^-T (L^-1 b + z) for every chain."""
    out = np.empty(a.shape, np.float64)
    for k in range(a.shape[0]):
        Q = np.diag(a[k].astype(np.float64)) + np.diag(c[k, :-1].astype(np.float64), 1) \
            + np.diag(c[k, :-1].astype(np.float64), -1)
        L = np.linalg.cholesky(Q)
        out[k] = np.linalg.solve(L.T, np.linalg.solve(L, b[k].astype(np.float64)) + z[k])
    return out


def box_muller_f64(bits1, bits2):
    u1 = ((bits1 >> 8).astype(np.float64) + 1.0) / 16777216.0
    u2 = (bits2 >> 8).astype(np.float64) / 16777216.0
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


@pytest.mark.parametrize("p", [16, 13])
def test_zero_bits_match_jax_interpret_kernel(p):
    """(a) All-zero bits: the port's plain version against JAX ``_pallas_batched``
    in interpret mode (p = 13 exercises the kernel's identity-row padding),
    B = 256 chains with their own Q and b; rtol/atol 2e-4."""
    from openmcmc_tpu.linalg.pallas_tridiag import _pallas_batched

    n_chains = 256
    a, c, b = random_tridiag(n_chains, p, seed=p)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_batched(jnp.asarray([7], jnp.int32), jnp.asarray(a), jnp.asarray(c),
                                          jnp.asarray(b)))
    zeros = torch.zeros((n_chains, p), dtype=torch.int64)
    got = tridiag.sample_canonical_tridiag(7, 0, *(torch.from_numpy(t) for t in (a, c, b)), bits=(zeros, zeros))
    assert got.shape == want.shape == (n_chains, p)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_chains,p", [(64, 16), (37, 9)])
def test_random_bits_match_float64_reference(n_chains, p):
    """(b) Random injected bits: float32 plain version against the float64
    x = L^-T (L^-1 b + z) on the same noise; rtol 1e-5, atol 1e-5."""
    a, c, b = random_tridiag(n_chains, p, seed=100 + p)
    rng = np.random.default_rng(p)
    bits = [rng.integers(0, 2**32, (n_chains, p), dtype=np.int64) for _ in range(2)]
    got = tridiag.sample_canonical_tridiag_plain(0, 0, *(torch.from_numpy(t) for t in (a, c, b)),
                                                 bits=[torch.from_numpy(t) for t in bits])
    want = reference_draw(a, c, b, box_muller_f64(*bits))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_philox_stream_is_per_chain_and_call():
    """The Philox counter is (chain, call, site, row group): a chain's draw does not
    depend on how many chains share the call, and another call draws anew."""
    a, c, b = (torch.from_numpy(t) for t in random_tridiag(40, 11, seed=3))
    full = tridiag.sample_canonical_tridiag(5, 2, a, c, b)
    head = tridiag.sample_canonical_tridiag(5, 2, a[:17], c[:17], b[:17])
    assert torch.equal(full[:17], head)
    assert not torch.equal(full, tridiag.sample_canonical_tridiag(5, 3, a, c, b))
    assert not torch.equal(full, tridiag.sample_canonical_tridiag(6, 2, a, c, b))
    bits = prng.sweep_bits(5, 40, 2, (11, 11), "cpu")
    assert torch.equal(full, tridiag.sample_canonical_tridiag_plain(5, 2, a, c, b, bits=bits))
    assert all(int(t.min()) >= 0 and int(t.max()) < 2**32 for t in bits)


def test_philox_draw_has_the_canonical_moments():
    """With Philox bits and one Q, b shared by every chain, the chain mean of x is
    Q^-1 b within 5 sd / sqrt(B) and the chain variance is diag(Q^-1) within 10 %."""
    n_chains, p = 4096, 13
    a, c, b = random_tridiag(1, p, seed=11)
    x = tridiag.sample_canonical_tridiag(
        9, 4, *(torch.from_numpy(np.repeat(t, n_chains, 0)) for t in (a, c, b))).numpy().astype(np.float64)
    Q = np.diag(a[0]) + np.diag(c[0, :-1], 1) + np.diag(c[0, :-1], -1)
    cov = np.linalg.inv(Q.astype(np.float64))
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(x.mean(0) - cov @ b[0]) < 5.0 * sd / np.sqrt(n_chains))
    assert np.all(np.abs(x.var(0) / np.diag(cov) - 1.0) < 0.1)


def test_canonical_sampler_routes_tridiagonal_to_k3():
    """gmrf.sample_normal_canonical sends a chain-batched tridiagonal Banded Q with a
    single column to the K3 wrapper, with the key's seed and counter, and keeps
    the (chains, p, 1) shape; a bandwidth-2 Q takes the Cholesky path."""
    a, c, b = (torch.from_numpy(t) for t in random_tridiag(6, 10, seed=4))
    Q = tst.Banded(torch.stack([a, c], dim=1))
    key = tgmrf.Key(torch.Generator().manual_seed(0), seed=3, counter=8)
    x = tgmrf.sample_normal_canonical(key, b[:, :, None], Q=Q)
    assert x.shape == (6, 10, 1)
    assert torch.equal(x[..., 0], tridiag.sample_canonical_tridiag(3, 8, a, c, b))
    wide = tst.Banded(torch.cat([Q.bands, torch.zeros(6, 1, 10)], dim=1))
    y = tgmrf.sample_normal_canonical(key, b[:, :, None], Q=wide)
    assert y.shape == (6, 10, 1) and torch.all(torch.isfinite(y))


def test_shape_checks():
    a, c, b = (torch.from_numpy(t) for t in random_tridiag(4, 5, seed=0))
    with pytest.raises(ValueError, match="must match"):
        tridiag.sample_canonical_tridiag(0, 0, a, c[:, :4], b)
    with pytest.raises(ValueError, match="non-empty"):
        tridiag.sample_canonical_tridiag(0, 0, a[0], c[0], b[0])


def test_band_rows_in_place_match_copies_and_jax(monkeypatch):
    """The draw on the band rows of a batched Banded, a = bands[:, 0] and
    c = bands[:, 1] with row stride 2p, equals the draw on contiguous copies, and
    the kernel's wrapper takes such rows as they are (a transposed tensor it
    copies); then gmrf.sample_normal_canonical on that Banded, fed all-zero bits,
    equals the JAX package's Pallas kernel in interpret mode (whose PRNG stub
    returns zero bits) within rtol/atol 2e-4. B = 40, p = 13."""
    from openmcmc_tpu.linalg.pallas_tridiag import _pallas_batched

    n_chains, p = 40, 13
    a, c, b = random_tridiag(n_chains, p, seed=21)
    bands = torch.from_numpy(np.stack([a, c], axis=1))
    av, cv, bt = bands[:, 0, :], bands[:, 1, :], torch.from_numpy(b)
    assert av.stride() == (2 * p, 1) and not cv.is_contiguous()
    got = tridiag.sample_canonical_tridiag(5, 2, av, cv, bt)
    assert torch.equal(got, tridiag.sample_canonical_tridiag(5, 2, av.contiguous(), cv.contiguous(), bt))
    assert tridiag._rows(cv).data_ptr() == cv.data_ptr()
    transposed = torch.from_numpy(np.ascontiguousarray(a.T)).t()
    assert tridiag._rows(transposed).is_contiguous() and not transposed.is_contiguous()

    def zero_bits(seed, n, call, widths, device):
        return [torch.zeros((n, w), dtype=torch.int64, device=device) for w in widths]

    monkeypatch.setattr(prng, "sweep_bits", zero_bits)
    key = tgmrf.Key(torch.Generator().manual_seed(0), seed=3, counter=8)
    x = tgmrf.sample_normal_canonical(key, bt[:, :, None], Q=tst.Banded(bands))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_batched(jnp.asarray([3], jnp.int32), jnp.asarray(a), jnp.asarray(c),
                                          jnp.asarray(b)))
    assert x.shape == (n_chains, p, 1)
    np.testing.assert_allclose(x[..., 0].numpy(), want, rtol=2e-4, atol=2e-4)
