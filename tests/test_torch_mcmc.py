"""The port's main path as a whole: the flagship smoother through MCMC.run(engine="auto").

The model has the structure of bench.py's (RW1 prior with a 1e-3 ridge, Gamma
scales, NormalNormal + two NormalGammas) at p = 16. Both packages run it; the JAX
package in interpret mode with host bits, the port on the CPU with the same bits
(see tests/test_torch_spectral.py), its state carried across by
``convert.state_from_reference``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openmcmc_tpu.fused import prng as jprng
from test_torch_spectral import jax_kernel_bits

torch.set_num_threads(2)

P = 16
SEED = 7


@pytest.fixture
def host_stats():
    jax.clear_caches()
    src = jprng.HostBitSource()
    with pltpu.force_tpu_interpret_mode(), jprng.host_bits(src):
        yield src
    jax.clear_caches()


def reference_state():
    from openmcmc_tpu.linalg import gmrf
    from openmcmc_tpu.linalg import structured as st

    rng = np.random.default_rng(0)
    s = np.linspace(0.0, 60.0, P)
    P_lambda = gmrf.precision_irregular(jnp.asarray(s))
    P_lambda = st.Banded(P_lambda.bands.at[0, 0].add(0.001))
    y = np.sin(s / 20.0) + 2.0 * np.cos(s / 12.0) + 2.0 + rng.normal(0.0, 1.0, P)
    return {
        "y": y, "b": y.copy(), "mu": np.zeros(P), "lambda": 100.0, "P_lambda": P_lambda,
        "a_lam": 10.0, "b_lam": 1.0, "tau": 1.0, "P_tau": st.Diagonal(jnp.ones(P)),
        "a_tau": 1.0, "b_tau": 1.0,
    }


def build(pkg, state, n_thin, store_names, response, **kw):
    """The flagship model in either package (they share class names)."""
    import importlib

    dist = importlib.import_module(f"{pkg}.distributions")
    params = importlib.import_module(f"{pkg}.parameters")
    smp = importlib.import_module(f"{pkg}.samplers")
    Model = importlib.import_module(f"{pkg}.model").Model
    MCMC = importlib.import_module(f"{pkg}.mcmc").MCMC
    mdl = Model([
        dist.Normal("y", mean="b", precision=params.ScaledMatrix("P_tau", "tau")),
        dist.Normal("b", mean="mu", precision=params.ScaledMatrix("P_lambda", "lambda")),
        dist.Gamma("lambda", shape="a_lam", rate="b_lam"),
        dist.Gamma("tau", shape="a_tau", rate="b_tau"),
    ], response=response)
    samplers = [smp.NormalNormal("b", mdl), smp.NormalGamma("lambda", mdl), smp.NormalGamma("tau", mdl)]
    return MCMC(state, samplers, mdl, n_burn=3, n_iter=5, n_thin=n_thin, n_chains=8, seed=SEED,
                store_names=store_names, **kw)


def test_flagship_slice_matches_jax(host_stats):
    """Thinned run with fitted values: dispatch, in-kernel thinning, store
    contract and values all agree with the JAX package."""
    from openmcmc_tpu_torch.convert import state_from_reference

    state = reference_state()
    response = {"y": "mean"}
    want = build("openmcmc_tpu", state, 2, None, response).run(engine="auto")
    mcmc = build("openmcmc_tpu_torch", state_from_reference(state, device="cpu"), 2, None, response,
                 device="cpu")
    got = mcmc.run(engine="auto", bit_source=jax_kernel_bits(SEED, P))

    assert got.engine == want.engine == "fused_smoother_spectral"
    assert sorted(got.store) == sorted(want.store) == ["b", "lambda", "tau", "y_fitted"]
    shapes = {"b": (8, 5, P, 1), "y_fitted": (8, 5, P, 1), "lambda": (8, 5, 1, 1), "tau": (8, 5, 1, 1)}
    for name in got.store:
        assert tuple(got.store[name].shape) == tuple(want.store[name].shape) == shapes[name], name
        np.testing.assert_allclose(got.store[name].numpy(), np.asarray(want.store[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    lp_t, lp_j = got.log_post.numpy(), np.asarray(want.log_post)
    assert lp_t.shape == lp_j.shape == (8, 5)
    assert np.all(np.abs(lp_t - lp_j) <= 1e-4 * np.maximum(1.0, np.abs(lp_j)))
    assert sorted(got.final_state) == sorted(want.final_state)
    for name, value in got.final_state.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(want.final_state[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert got.stats == {"b": {}, "lambda": {}, "tau": {}}

    # store_names filters the store (final_state keeps every sampled entry) and
    # response=None drops the fitted values, as in the JAX driver's _run_fused
    mcmc.store_names = ["tau", "lambda"]
    mcmc.model.response = None
    narrow = mcmc.run(engine="auto", bit_source=jax_kernel_bits(SEED, P))
    assert sorted(narrow.store) == ["lambda", "tau"]
    assert sorted(narrow.final_state) == ["b", "lambda", "tau"]
    for name in narrow.store:
        assert torch.equal(narrow.store[name], got.store[name]), name


def test_ess_per_param_matches_jax():
    from openmcmc_tpu.diagnostics import ess_per_param as jess
    from openmcmc_tpu_torch.diagnostics import effective_sample_size, ess_per_param

    rng = np.random.default_rng(5)
    m, n, k = 8, 300, 6
    phi = np.linspace(-0.3, 0.9, k)
    x = np.zeros((m, n, k))
    x[:, 0] = rng.normal(size=(m, k))
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + rng.normal(size=(m, k))
    x = x.astype(np.float32)
    want = np.asarray(jax.jit(jess)(jnp.asarray(x)))
    np.testing.assert_allclose(ess_per_param(torch.from_numpy(x)).numpy(), want, rtol=1e-3)
    np.testing.assert_allclose(ess_per_param(torch.from_numpy(x), chunk_size=4).numpy(), want, rtol=1e-3)
    np.testing.assert_allclose(float(effective_sample_size(torch.from_numpy(x[:, :, 0]))), want[0], rtol=1e-3)


def test_rhat_and_summary_match_jax():
    """split_rhat, rhat_per_param and summary against the JAX package's on AR(1)
    draws with shifted chains (so R-hat is well above 1), float32; rtol 1e-5
    (ESS: rtol 1e-3, as in test_ess_per_param_matches_jax)."""
    from openmcmc_tpu import diagnostics as jdiag
    from openmcmc_tpu_torch import diagnostics as tdiag

    rng = np.random.default_rng(9)
    m, n = 6, 201
    x = np.zeros((m, n, 2, 3))
    x[:, 0] = rng.normal(size=(m, 2, 3))
    for t in range(1, n):
        x[:, t] = 0.6 * x[:, t - 1] + rng.normal(size=(m, 2, 3))
    x = (x + 0.3 * np.arange(m)[:, None, None, None]).astype(np.float32)
    tx = torch.from_numpy(x)
    # the three JAX references compiled as one program (eagerly each op would compile on its own)
    j_split, j_rhat, want = jax.jit(lambda v: (jdiag.split_rhat(v[:, :, 0, 0]), jdiag.rhat_per_param(v),
                                               jdiag.summary(v)))(jnp.asarray(x))
    np.testing.assert_allclose(float(tdiag.split_rhat(tx[:, :, 0, 0])), float(j_split), rtol=1e-5)
    np.testing.assert_allclose(tdiag.rhat_per_param(tx).numpy(), np.asarray(j_rhat), rtol=1e-5)
    got = tdiag.summary(tx)
    assert sorted(got) == sorted(want)
    for name in got:
        assert tuple(got[name].shape) == tuple(want[name].shape) == (2, 3), name
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-3 if name == "ess" else 1e-5,
                                   atol=1e-6, err_msg=name)


def test_unported_routes_raise():
    """run() runs the generic driver; "auto" without a matching engine falls back
    to it, as in the JAX package; "fused" without a match raises; a resume
    continues the chains in the generic driver; a truncated latent prior now
    dispatches to the Thomas kernel K4's truncated variant, as in the JAX
    package."""
    from openmcmc_tpu_torch.convert import state_from_reference
    from openmcmc_tpu_torch.distributions import Normal

    mcmc = build("openmcmc_tpu_torch", state_from_reference(reference_state(), device="cpu"), 1, None, None,
                 device="cpu")
    first = mcmc.run()
    assert first.engine == "generic"
    resumed = mcmc.run(resume=first)
    assert resumed.engine == "generic" and resumed.final_key not in (first.final_key, mcmc.seed)
    with pytest.raises(ValueError, match="bit_source"):
        mcmc.run(bit_source=lambda *a: None)
    from openmcmc_tpu_torch.linalg import structured as st

    # a banded noise precision (here still diagonal in value) is no smoother the
    # dispatcher knows: nothing matches
    p_tau = mcmc.data["P_tau"]
    mcmc.data["P_tau"] = st.Banded(torch.stack([p_tau.diag_, torch.zeros_like(p_tau.diag_)]))
    res = mcmc.run(engine="auto")
    assert res.engine == "generic" and tuple(res.store["b"].shape) == (8, 5, P, 1)
    with pytest.raises(ValueError, match="no fused engine matches"):
        mcmc.run(engine="fused")
    mcmc.data["P_tau"] = p_tau
    mcmc.model["b"] = Normal("b", mean="mu", precision=mcmc.model["b"].precision, domain_response_lower=0.0)
    res = mcmc.run(engine="auto")
    assert res.engine == "fused_gmrf_smoother_truncated" and tuple(res.store["b"].shape) == (8, 5, P, 1)
    assert float(res.store["b"].min()) >= 0.0
