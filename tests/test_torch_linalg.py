"""The port's structured linear algebra, GMRF builder and state conversion
against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmcmc_tpu.linalg import gmrf as jgmrf
from openmcmc_tpu.linalg import structured as jst
from openmcmc_tpu_torch.convert import state_from_reference
from openmcmc_tpu_torch.linalg import gmrf as tgmrf
from openmcmc_tpu_torch.linalg import structured as tst

torch.set_num_threads(2)


def _pairs(p=9, seed=0):
    rng = np.random.default_rng(seed)
    s = np.cumsum(rng.uniform(0.2, 2.0, p))
    A = rng.normal(size=(p, p))
    dense = (A @ A.T / p + np.eye(p)).astype(np.float32)
    diag = rng.uniform(0.5, 2.0, p).astype(np.float32)
    return s, [
        (jgmrf.precision_irregular(jnp.asarray(s)), tgmrf.precision_irregular(s)),
        (jst.Diagonal(jnp.asarray(diag)), tst.Diagonal(torch.from_numpy(diag))),
        (jst.Dense(jnp.asarray(dense)), tst.Dense(torch.from_numpy(dense))),
    ]


def test_precision_irregular_matches_jax():
    s, pairs = _pairs()
    np.testing.assert_array_equal(pairs[0][1].bands.numpy(), np.asarray(pairs[0][0].bands))
    np.testing.assert_array_equal(tgmrf.precision_irregular(s, banded=False).numpy(),
                                  np.asarray(jgmrf.precision_irregular(jnp.asarray(s), banded=False)))


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["banded", "diagonal", "dense"])
def test_structured_ops_match_jax(kind):
    import jax

    _, pairs = _pairs()
    j, t = pairs[kind]
    x = np.random.default_rng(1).normal(size=(9, 2)).astype(np.float32)
    assert tst.dim(t) == jst.dim(j) == 9
    if kind == 0:  # the RW1 prior is intrinsic: ridge it for the log-determinant, as bench.py does
        j_det = jst.Banded(j.bands.at[0, 0].add(1e-3))
        t_det = tst.Banded(torch.from_numpy(np.array(j_det.bands)))
    else:
        j_det, t_det = j, t
    # the JAX references compiled as one program (eagerly each operation would compile on its own)
    ref = jax.jit(lambda v: dict(dense=jst.to_dense(j), diag=jst.diag(j), mv=jst.matvec(j, v),
                                 mv_scaled=jst.matvec(jst.scale(2.5, j), v[:, 0]),
                                 logdet=jst.chol_log_det(jst.cholesky(j_det))))(jnp.asarray(x))
    np.testing.assert_allclose(tst.to_dense(t).numpy(), np.asarray(ref["dense"]), rtol=1e-6)
    np.testing.assert_allclose(tst.diag(t).numpy(), np.asarray(ref["diag"]), rtol=1e-6)
    np.testing.assert_allclose(tst.matvec(t, torch.from_numpy(x)).numpy(), np.asarray(ref["mv"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tst.matvec(tst.scale(2.5, t), torch.from_numpy(x[:, 0])).numpy(),
                               np.asarray(ref["mv_scaled"]), rtol=1e-5, atol=1e-5)
    want = float(ref["logdet"])
    got = float(tst.chol_log_det(tst.cholesky(t_det)))
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (got, want)


def test_intrinsic_prior_logdet_is_clamped_and_finite():
    t = tgmrf.precision_irregular(np.linspace(0.0, 10.0, 12))
    chol = tst.cholesky(t)
    assert torch.all(torch.isfinite(chol.bands))
    assert torch.isfinite(tst.chol_log_det(chol))
    assert float(chol.bands[0, -1]) <= 1e-2  # the null direction's pivot sits at the clamp's scale


def test_state_from_reference():
    _, pairs = _pairs()
    ref = {"y": np.arange(3.0), "n": np.arange(3), "lam": 2.0, "P": pairs[0][0], "D": pairs[1][0], "Q": pairs[2][0]}
    got = state_from_reference(ref, device="cpu")
    assert got["y"].shape == (3, 1) and got["y"].dtype == torch.float32
    assert got["n"].dtype == torch.int32 and got["lam"].shape == (1, 1)
    assert isinstance(got["P"], tst.Banded) and isinstance(got["D"], tst.Diagonal) and isinstance(got["Q"], tst.Dense)
    np.testing.assert_array_equal(got["P"].bands.numpy(), np.asarray(pairs[0][0].bands))
    perm = jst.permuted(pairs[0][0], np.arange(9)[::-1])
    with pytest.raises(NotImplementedError, match="Permuted"):
        state_from_reference({"P": perm}, device="cpu")
    with pytest.raises(TypeError):
        state_from_reference({"x": object()}, device="cpu")


def _banded_spd(bw, p, batch=(), seed=0):
    """Diagonally dominant symmetric banded matrices in lower band storage, float64."""
    rng = np.random.default_rng(seed + 10 * bw)
    bands = rng.uniform(-0.5, 0.5, batch + (bw + 1, p))
    bands[..., 0, :] = 2.0 * bw + rng.uniform(0.5, 1.5, batch + (p,))
    for j in range(1, bw + 1):
        bands[..., j, p - j:] = 0.0
    return bands


def _jax_batched(fn, batched):
    """fn over the leading axis of its arguments with jax.vmap when ``batched``."""
    import jax

    return jax.vmap(fn) if batched else fn


@pytest.mark.parametrize("batched", [False, True], ids=["unbatched", "batched"])
@pytest.mark.parametrize("bw", [1, 2, 3])
def test_banded_factor_and_solves_match_jax_x64(bw, batched):
    """(c) Banded Cholesky, the triangular solves, cho_solve, solve, chol_matvec_t
    and mvn_log_pdf against the JAX package's at float64 (``jax.enable_x64``),
    unbatched and with a leading batch axis of 3; rtol 1e-10."""
    import jax

    p, batch = 11, ((3,) if batched else ())
    bands = _banded_spd(bw, p, batch)
    rng = np.random.default_rng(bw)
    rhs = rng.normal(size=batch + (p, 2))
    mu = rng.normal(size=(p, 1))
    T = tst.Banded(torch.from_numpy(bands))
    tr, tmu = torch.from_numpy(rhs), torch.from_numpy(mu)
    with jax.enable_x64(True):
        J = lambda bd: jst.Banded(bd)  # noqa: E731

        def jax_all(bd, r):
            chol = jst.cholesky(J(bd))
            return dict(
                chol=chol.bands, lower=jst.solve_lower(chol, r), upper=jst.solve_upper_t(chol, r),
                cho=jst.cho_solve(chol, r), solve=jst.solve(J(bd), r), lt=jst.chol_matvec_t(chol, r),
                logdet=jst.chol_log_det(chol),
                lp=jgmrf.mvn_log_pdf(r, jnp.asarray(mu), Q=J(bd), by_observation=True),
                lp_sum=jgmrf.mvn_log_pdf(r, jnp.asarray(mu), Q=J(bd)),
            )

        # compiled as one program: eagerly, every operation of the scans would compile on its own
        want = {k: np.asarray(v)
                for k, v in jax.jit(_jax_batched(jax_all, batched))(jnp.asarray(bands), jnp.asarray(rhs)).items()}
    chol = tst.cholesky(T)
    got = dict(
        chol=chol.bands, lower=tst.solve_lower(chol, tr), upper=tst.solve_upper_t(chol, tr),
        cho=tst.cho_solve(chol, tr), solve=tst.solve(T, tr), lt=tst.chol_matvec_t(chol, tr),
        logdet=tst.chol_log_det(chol), lp=tgmrf.mvn_log_pdf(tr, tmu, Q=T, by_observation=True),
        lp_sum=tgmrf.mvn_log_pdf(tr, tmu, Q=T),
    )
    for name, value in got.items():
        assert value.dtype == torch.float64, name
        np.testing.assert_allclose(value.numpy(), want[name], rtol=1e-10, atol=1e-12, err_msg=name)
    # the solves invert what they claim to, on the dense matrix
    dense = tst.to_dense(T).numpy()
    np.testing.assert_allclose(dense @ got["solve"].numpy(), rhs, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kind", ["dense", "diagonal"])
def test_dense_and_diagonal_solves_match_jax_x64(kind):
    """(c) The same functions on Dense (batched torch.linalg) and Diagonal
    factors, batched over 2, at float64; rtol 1e-10."""
    import jax

    p = 7
    rng = np.random.default_rng(5)
    A = rng.normal(size=(2, p, p))
    mats = A @ A.transpose(0, 2, 1) / p + np.eye(p) if kind == "dense" else rng.uniform(0.5, 2.0, (2, p))
    rhs = rng.normal(size=(2, p, 3))
    mu = rng.normal(size=(p, 1))
    jcls, tcls = (jst.Dense, tst.Dense) if kind == "dense" else (jst.Diagonal, tst.Diagonal)
    with jax.enable_x64(True):
        def jax_all(m, r):
            chol = jst.cholesky(jcls(m))
            return dict(cho=jst.cho_solve(chol, r), lt=jst.chol_matvec_t(chol, r), logdet=jst.chol_log_det(chol),
                        lp=jgmrf.mvn_log_pdf(r, jnp.asarray(mu), Q=jcls(m), by_observation=True))

        want = {k: np.asarray(v) for k, v in jax.jit(jax.vmap(jax_all))(jnp.asarray(mats), jnp.asarray(rhs)).items()}
    T = tcls(torch.from_numpy(mats))
    tr = torch.from_numpy(rhs)
    chol = tst.cholesky(T)
    got = dict(cho=tst.cho_solve(chol, tr), lt=tst.chol_matvec_t(chol, tr), logdet=tst.chol_log_det(chol),
               lp=tgmrf.mvn_log_pdf(tr, torch.from_numpy(mu), Q=T, by_observation=True))
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name], rtol=1e-10, atol=1e-12, err_msg=name)


def test_batched_add_and_scale_broadcast():
    """A chain-batched scalar times constant banded data plus a batched diagonal
    stays Banded, with the batch axis, and densifies as the dense sum."""
    p = 6
    bands = torch.from_numpy(_banded_spd(2, p))
    lam = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64).reshape(3, 1, 1)
    diag = torch.rand(3, p, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    Q = tst.add(tst.scale(lam, tst.Banded(bands)), tst.Diagonal(diag))
    assert isinstance(Q, tst.Banded) and Q.bands.shape == (3, 3, p)
    want = lam * tst.to_dense(tst.Banded(bands)) + torch.diag_embed(diag)
    torch.testing.assert_close(tst.to_dense(Q), want, rtol=1e-12, atol=1e-12)
    x = torch.rand(3, p, 2, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(tst.matvec(Q, x), want @ x, rtol=1e-12, atol=1e-12)
