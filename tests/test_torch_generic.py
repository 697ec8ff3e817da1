"""The port's generic driver (``MCMC.run(engine="generic")``) against the JAX
package's generic driver and against the port's own spectral engine.

Both packages draw from different streams (threefry against torch's generator
and Philox), so whole runs are compared in distribution, with the thresholds of
tests/test_fused_engines_cpu_stats.py (``_check_smoother_parity``: posterior
means within 0.12 sd, sds within 10 % for b and 12 % for the scales). The
store contract and the stored log-posterior are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_fused_engines_cpu_stats import _check_smoother_parity, _generic_smoother, _smoother_problem
from test_torch_mcmc import build, reference_state

torch.set_num_threads(2)


def port_smoother(s, y, n_chains=128, n_iter=400, drop=()):
    """``_generic_smoother``'s model (p = 12 intrinsic RW1 prior, Gamma(2, 1)
    scales, 200 burn-in sweeps) in the port, on the CPU."""
    from openmcmc_tpu_torch import MCMC, Model
    from openmcmc_tpu_torch.distributions import Gamma, Normal
    from openmcmc_tpu_torch.linalg import gmrf
    from openmcmc_tpu_torch.linalg import structured as st
    from openmcmc_tpu_torch.parameters import ScaledMatrix
    from openmcmc_tpu_torch.samplers import NormalGamma, NormalNormal

    p = len(s)
    mdl = Model([
        Normal("y", mean="b", precision=ScaledMatrix("P_tau", "tau")),
        Normal("b", mean="mu", precision=ScaledMatrix("P0", "lam")),
        Gamma("lam", shape="a_lam", rate="b_lam"),
        Gamma("tau", shape="a_tau", rate="b_tau"),
    ])
    state = {
        "y": y.reshape(p, 1), "b": y.reshape(p, 1).copy(), "mu": np.zeros((p, 1)),
        "P0": gmrf.precision_irregular(np.asarray(s, np.float32)), "P_tau": st.Diagonal(torch.ones(p)),
        "lam": 1.0, "tau": 1.0, "a_lam": 2.0, "b_lam": 1.0, "a_tau": 2.0, "b_tau": 1.0,
    }
    for name in drop:
        del state[name]
    samplers = [NormalNormal("b", mdl), NormalGamma("lam", mdl), NormalGamma("tau", mdl)]
    return MCMC(state, samplers, mdl, n_burn=200, n_iter=n_iter, n_chains=n_chains, seed=6, device="cpu")


@pytest.fixture(scope="module")
def port_generic():
    s, y = _smoother_problem()
    res = port_smoother(s, y).run()
    assert res.engine == "generic"
    return res


def _parity(res, gen):
    _check_smoother_parity(res.store["b"].numpy(), res.store["lam"].numpy(), res.store["tau"].numpy(), gen)


def test_generic_matches_jax_generic(port_generic):
    """(d) Port generic against JAX generic on ``_generic_smoother``'s model: 128
    chains, 200 burn-in, 400 stored; ``_check_smoother_parity``'s tolerances."""
    s, y = _smoother_problem()
    _parity(port_generic, _generic_smoother(s, y))


def test_generic_matches_port_spectral_engine(port_generic):
    """(d) The same model through the port's spectral engine (``engine="auto"``,
    its plain version on the CPU) against the port's generic run, with the
    same tolerances, the generic run in the reference's place."""
    s, y = _smoother_problem()
    fused = port_smoother(s, y, n_chains=512).run(engine="auto")
    assert fused.engine == "fused_smoother_spectral"
    _parity(fused, port_generic)


def test_store_contract_and_log_post_match_jax():
    """(e) Store keys, shapes, final_state and log_post shapes equal the JAX generic
    result's on the flagship model at p = 16 with fitted values and n_thin = 2;
    the port's stored log_post equals the JAX ``Model.log_p`` re-evaluated on the
    port's own draws, to rtol 1e-5."""
    from openmcmc_tpu_torch.convert import state_from_reference

    state = reference_state()
    want = build("openmcmc_tpu", state, 2, None, {"y": "mean"}).run()
    mcmc = build("openmcmc_tpu_torch", state_from_reference(state, device="cpu"), 2, None, {"y": "mean"},
                 device="cpu")
    got = mcmc.run()
    assert got.engine == "generic"
    assert sorted(got.store) == sorted(want.store) == ["b", "lambda", "tau", "y_fitted"]
    for name in got.store:
        assert tuple(got.store[name].shape) == tuple(want.store[name].shape), name
        assert got.store[name].dtype == torch.float32 and bool(torch.all(torch.isfinite(got.store[name])))
    assert torch.equal(got.store["y_fitted"], got.store["b"])
    assert tuple(got.log_post.shape) == tuple(want.log_post.shape) == (8, 5)
    assert sorted(got.final_state) == sorted(want.final_state)
    for name, value in got.final_state.items():
        assert tuple(value.shape) == tuple(want.final_state[name].shape), name
        assert torch.equal(value, got.store[name][:, -1]), name
    assert got.stats == {"b": {}, "lambda": {}, "tau": {}}

    model = build("openmcmc_tpu", state, 2, None, None).model
    data = {k: v for k, v in build("openmcmc_tpu", state, 2, None, None).data.items()}
    draws = {name: jnp.asarray(got.store[name].numpy().reshape((40,) + tuple(got.store[name].shape[2:])))
             for name in ("b", "lambda", "tau")}
    ref = jax.jit(jax.vmap(lambda d: model.log_p({**data, **d})))(draws)
    np.testing.assert_allclose(got.log_post.numpy().reshape(-1), np.asarray(ref), rtol=1e-5)


def test_missing_parameters_are_drawn_from_their_priors():
    """(f) Sampled entries left out of the state are drawn from their priors, in
    sampler order: lam from Gamma(2, 1) (mean 2, variance 2; mean within 5 sd /
    sqrt(4096), variance within 15 %), and the run goes on to finite draws. On
    the flagship model (ridged RW1 prior), a missing b is drawn from
    N(mu, (lambda P)^-1): its first increment has variance h / lambda, within 15 %."""
    from openmcmc_tpu_torch.convert import state_from_reference

    s, y = _smoother_problem()
    mcmc = port_smoother(s, y, n_chains=4096, n_iter=3, drop=("lam",))
    assert "lam" not in mcmc.initial_chain_state
    init = mcmc._init_chain_state(torch.Generator().manual_seed(0))
    lam = init["lam"].reshape(-1).double()
    assert init["lam"].shape == (4096, 1, 1) and init["b"].shape == (4096, 12, 1)
    assert abs(float(lam.mean()) - 2.0) < 5.0 * np.sqrt(2.0 / 4096)
    assert abs(float(lam.var()) / 2.0 - 1.0) < 0.15
    mcmc.n_burn = 2
    res = mcmc.run()
    assert all(bool(torch.all(torch.isfinite(v))) for v in res.store.values())
    assert bool(torch.all(torch.isfinite(res.log_post)))

    state = reference_state()
    del state["b"]
    flagship = build("openmcmc_tpu_torch", state_from_reference(state, device="cpu"), 1, None, None, device="cpu")
    flagship.n_chains = 4096
    b = flagship._init_chain_state(torch.Generator().manual_seed(1))["b"].double()
    assert b.shape == (4096, 16, 1)
    h = 60.0 / 15
    inc = b[:, 1, 0] - b[:, 0, 0]
    assert abs(float(inc.mean())) < 5.0 * np.sqrt(h / 100.0 / 4096)
    assert abs(float(inc.var()) * 100.0 / h - 1.0) < 0.15
