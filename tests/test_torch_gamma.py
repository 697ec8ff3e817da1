"""The port's batched Gamma draws (openmcmc_tpu_torch.linalg.gamma, kernel K12)
and ``fast_gamma`` against the JAX package's.

The JAX kernel runs in interpret mode, whose PRNG stub gives zero bits, so the
port's plain version fed zero bits must reproduce it value for value. On the
port's own Philox bits both samplers are held against scipy's Gamma by a KS
test and the first two moments, as ``tests/test_fast_gamma.py`` holds the JAX
package's ``fast_gamma``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch
from jax.experimental.pallas import tpu as pltpu

from openmcmc_tpu.linalg.pallas_gamma import _pallas_gamma_flat
from openmcmc_tpu_torch.linalg import fast_gamma
from openmcmc_tpu_torch.linalg import gamma as tgamma

torch.set_num_threads(2)

SHAPES = [0.5, 1.0, 2.5, 50.5, 500.0]


def zero_bits(site, shape):
    return torch.zeros(shape, dtype=torch.int64)


def test_plain_on_zero_bits_matches_jax_interpret():
    """Zero bits: every uniform is 2^-25; the first round accepts, and a < 1
    takes the boost. 512 elements, shapes {0.5, 1.5, 4, 8}, rtol 1e-6."""
    a = np.repeat(np.array([0.5, 1.5, 4.0, 8.0], np.float32), 128)
    jax.clear_caches()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(_pallas_gamma_flat)(jnp.asarray([11], jnp.int32), jnp.asarray(a)))
    jax.clear_caches()
    got = tgamma.gamma_plain(11, torch.from_numpy(a), bit_source=zero_bits).numpy()
    assert np.all(got > 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_plain_fallback_when_every_round_misses():
    """u1 = 2^-25 and u2 just above 1/2 give x = -5.9, so 1 + c x < 0 in every
    round for these shapes: the draw is d, for a < 1 times u^(1/a) with the
    boost uniform (site 18, zero bits) 2^-25."""
    a = torch.tensor([0.3, 0.9, 1.0, 2.0])

    def bits(site, shape):
        return torch.full(shape, 0x80000000 if site % 3 == 1 else 0, dtype=torch.int64)

    got = tgamma.gamma_plain(0, a, bit_source=bits)
    d = torch.where(a < 1.0, a + 1.0, a) - 1.0 / 3.0
    u = 0.5 / 2.0**24
    want = torch.where(a < 1.0, d * torch.tensor(u) ** (1.0 / a), d)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)


def _check_gamma_sample(x: np.ndarray, a: float):
    assert np.all(x > 0)
    p = sps.kstest(x, "gamma", args=(a,)).pvalue
    assert p > 1e-3, (a, p)
    np.testing.assert_allclose(x.mean(), a, rtol=0.03)
    np.testing.assert_allclose(x.var(), a, rtol=0.06)


@pytest.mark.parametrize("a", SHAPES)
def test_plain_ks(a):
    _check_gamma_sample(tgamma.gamma(5, torch.full((100000,), a)).double().numpy(), a)


@pytest.mark.parametrize("a", SHAPES)
def test_fast_gamma_ks(a):
    x = fast_gamma(torch.full((100000,), a), torch.Generator().manual_seed(0))
    _check_gamma_sample(x.double().numpy(), a)


def test_fast_gamma_rate():
    x = fast_gamma(torch.full((50000,), 4.0), torch.Generator().manual_seed(1), rate=2.0)
    np.testing.assert_allclose(float(x.double().mean()), 2.0, rtol=0.03)


def test_bits_follow_the_element_not_the_batch():
    """Element j's draw depends on (seed, j) only: a prefix of the batch draws
    the same values, any shape is drawn flat in row-major order, and another
    seed draws others; a CPU call takes the plain version and a CPU tensor is
    no kernel input."""
    a = torch.linspace(0.2, 30.0, 1001)
    full = tgamma.gamma(7, a)
    assert torch.equal(tgamma.gamma(7, a[:333]), full[:333])
    assert torch.equal(tgamma.gamma(7, a[:1000].reshape(10, 100)), full[:1000].reshape(10, 100))
    assert torch.equal(full, tgamma.gamma_plain(7, a))
    assert not torch.equal(tgamma.gamma(8, a), full)
    with pytest.raises(ValueError, match="CUDA"):
        tgamma.gamma_kernel(7, a)


def test_bits_are_the_fused_layout_per_site():
    """The plain version draws site k of element j from Philox counter
    (0, 0, k, j // 4), word j % 4: the fused engines' layout at chain 0 and
    sweep 0, one site at a time."""
    from openmcmc_tpu_torch.fused import prng

    a = torch.linspace(0.2, 30.0, 103)
    sites = prng.sweep_bits(7, 1, 0, [a.numel()] * tgamma.N_SITES, "cpu")
    want = tgamma.gamma_plain(7, a, bit_source=lambda site, _shape: sites[site][0])
    assert torch.equal(tgamma.gamma_plain(7, a), want)


def test_rounds_count_to_the_first_acceptance():
    """gamma_rounds is 1 where the first round accepts (zero bits), N_ROUNDS
    where every round misses, and near 1 on Philox bits, where a boosted
    shape of at least 1 accepts a round with probability above 0.95."""
    a = torch.tensor([0.3, 0.9, 1.0, 2.0])
    assert torch.equal(tgamma.gamma_rounds(0, a, bit_source=zero_bits), torch.ones(4, dtype=torch.int32))

    def miss(site, shape):
        return torch.full(shape, 0x80000000 if site % 3 == 1 else 0, dtype=torch.int64)

    assert torch.equal(tgamma.gamma_rounds(0, a, bit_source=miss), torch.full((4,), tgamma.N_ROUNDS, dtype=torch.int32))
    rounds = tgamma.gamma_rounds(3, torch.tensor(SHAPES).repeat(2000))
    assert int(rounds.min()) >= 1 and int(rounds.max()) <= tgamma.N_ROUNDS
    assert 1.0 < float(rounds.double().mean()) < 1.06


def test_first_accepted_round_wins():
    """Element j first accepts in round j % 7 (6: never). A missed round reads
    u1 = 2^-25 and u2 just above 1/2, so 1 + c x < 0 for these shapes; an
    accepting round r reads u1 = (r + 1) / 16, u2 = 2^-25 and u = 2^-25, a
    round of its own value. The plain version returns d v of exactly round
    j % 7, d when every round misses, each boosted by the site-18 uniform where
    a < 1; gamma_rounds returns j % 7 + 1, capped at N_ROUNDS. This is the rule
    the kernel's early exit keeps."""
    shapes = torch.tensor([0.3, 0.9, 1.0, 2.0, 3.5])
    a = shapes.repeat_interleave(7)  # element j: shape j // 7, first accepted round j % 7
    n = a.numel()
    target = torch.arange(n) % 7

    def bits(site, shape):
        if site == tgamma.N_SITES - 1:
            return torch.zeros(shape, dtype=torch.int64)
        r, kind = divmod(site, 3)
        accept = r >= target
        if kind == 0:
            return torch.where(accept, (r + 1) << 28, 0).to(torch.int64)
        return torch.where(accept | (kind == 2), 0, 0x80000000).to(torch.int64)

    got = tgamma.gamma_plain(0, a, bit_source=bits)
    d = torch.where(a < 1.0, a + 1.0, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    u1 = (torch.clamp(target, max=5).to(torch.float32) + 1.0) / 16.0 + 0.5 / 2.0**24
    x = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(torch.tensor(6.283185307179586) * (0.5 / 2.0**24))
    t = 1.0 + c * x
    want = torch.where(target < 6, d * (t * (t * t)), d)
    want = torch.where(a < 1.0, want * torch.tensor(0.5 / 2.0**24) ** (1.0 / a), want)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    per_shape = want.reshape(5, 7)
    assert all(len(set(row[:6].tolist())) == 6 for row in per_shape)  # each round's value differs
    rounds = tgamma.gamma_rounds(0, a, bit_source=bits)
    assert torch.equal(rounds, torch.clamp(target + 1, max=tgamma.N_ROUNDS).to(torch.int32))
