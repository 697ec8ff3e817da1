"""MCMC driver (port of ``openmcmc_tpu/mcmc.py``).

The state is split once into per-chain *sampled* entries and constant *data*
entries, as in the JAX package. Chains are an explicit leading axis of every
per-chain tensor (the JAX package vmaps); data stays unbatched and broadcasts.
Every tensor lives on the driver's ``device``, ``"cuda"`` unless the caller asks
for the CPU: a CUDA run stays on the card.

Engines: ``engine="generic"`` (the default) runs the samplers sweep by sweep,
all chains batched, in a Python loop (the JAX package's ``lax.scan``); on the
flagship smoother each NormalNormal step is one launch of kernel K3.
``"auto"`` runs the fused engine the dispatcher matches and falls back to the
generic driver when none matches, as in the JAX package; ``"fused"`` requires a
match. The fused engines so far: ``fused_smoother_spectral`` (kernel K1),
``fused_gmrf_smoother`` (a tridiagonal prior with p > 1024) and
``fused_gmrf_smoother_truncated`` (a box-truncated latent prior), both kernel K4,
for linear regression ``fused_linreg`` (p <= 16, kernel K6) and
``fused_linreg_spectral`` (p <= 256, kernel K5), and for the Metropolis family
``fused_random_walk`` (kernel K7), ``fused_mmala`` (p <= 16, kernel K8) and
``fused_mmala_spectral`` (p <= 256, kernel K9), for the Gaussian mixture
``fused_mixture`` and ``fused_mixture_conjugate`` (kernel K10), which store the
allocation Z as int32 (chains, n_iter, n, 1) like the generic driver, and for
the reversible-jump knot-basis regression ``fused_rj`` (kernel K11), which
stores the int32 count as (chains, n_iter, 1, 1) like the generic driver.

Randomness: the generic driver draws from one ``torch.Generator`` on the device,
seeded from ``seed`` (torch draws: Gamma variates, prior init, non-tridiagonal
Normal noise, truncated-normal uniforms, Metropolis proposals and accept
uniforms, mixture allocations, reversible-jump move types and deletion
indices), and K3 from Philox keyed by
``seed & 0x7FFFFFFF`` with a call
counter per (sweep, sampler). The streams differ from the JAX package's
threefry ones; its draws agree in distribution.

Not ported yet: ``run(resume=...)``, ``run_chunked`` and progress callbacks
(ROADMAP.md queue 1: operations), and a float64 mode in place of
``jax.enable_x64`` (state is float32; ROADMAP.md queue 1: operations).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from openmcmc_tpu_torch.distributions.location_scale import Normal
from openmcmc_tpu_torch.linalg import gmrf
from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.model import Model
from openmcmc_tpu_torch.parameters import ScaledMatrix
from openmcmc_tpu_torch.samplers.base import Sampler


def _coerce_state(state: dict, device="cuda") -> dict:
    """Coerce raw entries to >= 2-D column tensors on ``device``.

    Structured matrices pass through (as float32 on ``device``); integer arrays
    become int32, everything else float32; a scalar becomes (1, 1) and a vector
    (p, 1). A scipy.sparse entry raises: its RCM-permuted banded form is not
    ported yet (ROADMAP.md queue 1: sparse and permuted priors)."""
    device = torch.device(device)
    out = {}
    for name, value in state.items():
        if isinstance(value, st.STRUCTURED_TYPES):
            out[name] = st.to(value, device, torch.float32)
            continue
        sparse = sys.modules.get("scipy.sparse")
        if sparse is not None and sparse.issparse(value):
            raise NotImplementedError(
                f"state[{name!r}]: scipy.sparse entries are not ported yet "
                "(ROADMAP.md queue 1: sparse and permuted priors)"
            )
        t = value if torch.is_tensor(value) else torch.as_tensor(np.array(value))
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            t = t.to(torch.float32)
        elif t.dtype.is_complex:
            raise TypeError(f"state[{name!r}]: complex entries are not supported")
        else:
            t = t.to(torch.int32)
        if t.dim() == 0:
            t = t.reshape(1, 1)
        elif t.dim() == 1:
            t = t.reshape(-1, 1)
        out[name] = t.to(device)
    return out


class _StateDict(dict):
    """State-entry dict whose item assignment re-coerces onto the driver's device."""

    def __init__(self, entries: dict, device):
        super().__init__(entries)
        self._device = device

    def __setitem__(self, name, value):
        super().__setitem__(name, _coerce_state({name: value}, self._device)[name])

    def update(self, *args, **kwargs):
        for k, v in dict(*args, **kwargs).items():
            self[k] = v


@dataclasses.dataclass
class MCMCResult:
    """Output of a run.

    store[name] has shape (n_chains, n_iter) + state_shape; log_post is
    (n_chains, n_iter); final_state[name] is each sampled entry's last draw,
    (n_chains,) + state_shape; stats[param] holds each sampler's per-chain
    statistics (a Metropolis or reversible-jump sampler's accept and proposal
    counts over burn-in and sampling, its adapted log_step; a conjugate
    sampler's are empty)."""

    store: Dict[str, torch.Tensor]
    log_post: torch.Tensor
    stats: Dict[str, dict]
    final_state: Dict[str, torch.Tensor]
    #: which execution path produced this result: "generic" or a fused engine name
    engine: str = "generic"

    @property
    def acceptance(self) -> Dict[str, torch.Tensor]:
        """Per Metropolis sampler, the percentage of proposals accepted per chain."""
        from openmcmc_tpu_torch.samplers.metropolis import acceptance_rate

        return {name: acceptance_rate(s) for name, s in self.stats.items() if "proposal" in s}


class MCMC:
    """Drive a set of per-parameter samplers over a model.

    Args:
        state: initial values: data entries (constant across chains) and
            optionally initial values of the sampled parameters (the generic
            driver draws missing ones from their priors). Values may be tensors,
            arrays, numbers or structured matrices.
        samplers: one sampler per inferred parameter, applied in order each sweep.
        model: the full model (log_post and fitted-value storage).
        n_burn / n_iter / n_thin: burn-in, stored iterations, thinning (every
            stored iteration runs n_thin full sweeps).
        n_chains: number of independent chains.
        seed: the run's seed; the kernels' Philox key is ``seed & 0x7FFFFFFF``,
            the value the JAX package derives from ``PRNGKey(seed)``, and the
            generic driver's ``torch.Generator`` is seeded with ``seed``.
        store_names: sampled parameters to store (default: all).
        chain_state_names: extra per-chain entries.
        device: where every tensor lives and every engine runs; the card
            unless the caller asks for the CPU.
    """

    def __init__(
        self,
        state: dict,
        samplers: Sequence[Sampler],
        model: Model,
        n_burn: int = 5000,
        n_iter: int = 5000,
        n_thin: int = 1,
        n_chains: int = 1,
        seed: int = 0,
        store_names: Optional[List[str]] = None,
        chain_state_names: Sequence[str] = (),
        device="cuda",
    ):
        self.samplers = list(samplers)
        self.model = model
        self.n_burn = int(n_burn)
        self.n_iter = int(n_iter)
        self.n_thin = int(n_thin)
        self.n_chains = int(n_chains)
        self.seed = int(seed)
        self.device = torch.device(device)

        coerced = _coerce_state(state, self.device)
        # per-chain entries: everything a sampler can modify, then the extras
        chain_names = []
        for sampler in self.samplers:
            for name in getattr(sampler, "updated_names", [sampler.param]):
                if name not in chain_names:
                    chain_names.append(name)
        for name in chain_state_names:
            if name not in chain_names:
                chain_names.append(name)
        self.chain_state_names = chain_names
        self.data = _StateDict({k: v for k, v in coerced.items() if k not in chain_names}, self.device)
        self.initial_chain_state = _StateDict({k: v for k, v in coerced.items() if k in chain_names}, self.device)

        if store_names is None:
            store_names = list(chain_names)
        unknown = [n for n in store_names if n not in chain_names]
        if unknown:
            raise ValueError(f"store_names {unknown} are not sampled parameters; samplers update {chain_names}")
        self.store_names = list(store_names)
        self._carry_logp = self._carried_logp_params()

    def _carried_logp_params(self) -> frozenset:
        """Params whose Metropolis samplers get a carried current-state
        log-density: those whose conditional-model inputs no other sampler of the
        sweep modifies (always so for a single sampler). A per-run decision: the
        samplers key off the ``logp`` entry the driver seeds in their stats."""
        from openmcmc_tpu_torch.samplers.metropolis import ManifoldMALA, RandomWalk, RandomWalkLoop
        from openmcmc_tpu_torch.samplers.reversible_jump import ReversibleJump

        carried = set()
        for s in self.samplers:
            if not isinstance(s, (RandomWalk, ManifoldMALA, ReversibleJump)) or isinstance(s, RandomWalkLoop):
                continue
            deps = set()
            for dist in s.model.values():
                deps.update(dist.param_list)
            others = set()
            for o in self.samplers:
                if o is not s:
                    others.update(getattr(o, "updated_names", [o.param]))
            if not (deps & others):
                carried.add(s.param)
        return frozenset(carried)

    def run(self, resume: Optional[MCMCResult] = None, engine: str = "generic", bit_source=None) -> MCMCResult:
        """Run burn-in and sampling for all chains.

        ``engine``: "generic" (default) runs the samplers sweep by sweep; "auto"
        runs the fused engine that structurally matches the model and samplers
        (the whole run in one kernel launch on a CUDA device) and falls back to
        the generic driver otherwise; "fused" requires a match.

        ``bit_source(sweep, site, shape) -> uint32 bits`` replaces the fused
        engines' Philox bits; it takes a CPU driver and a fused engine only (the
        port of the JAX package's ``prng.host_bits``, used to feed both packages
        the same bits)."""
        if engine not in ("generic", "auto", "fused"):
            raise ValueError("engine must be 'generic', 'auto' or 'fused'")
        if resume is not None:
            raise NotImplementedError("run(resume=...) is not ported yet (ROADMAP.md queue 1: operations)")
        if engine in ("auto", "fused"):
            from openmcmc_tpu_torch.fused.dispatch import match_fused_engine

            runner = match_fused_engine(self)
            if runner is not None:
                return self._run_fused(runner, bit_source)
            if engine == "fused":
                raise ValueError("engine='fused': no fused engine matches this model/sampler configuration")
        if bit_source is not None:
            raise ValueError("bit_source replaces a fused engine's bits; the generic driver draws from its generator")
        return self._run_generic()

    # -- the generic driver --------------------------------------------------

    def _full_state(self, chain_state: dict) -> dict:
        full = dict(self.data)
        full.update(chain_state)
        return full

    def _init_chain_state(self, generator: torch.Generator) -> dict:
        """Per-chain state: given initial values broadcast to every chain, and
        missing sampled parameters drawn from their priors, in sampler order."""
        n = self.n_chains
        chain_state = {name: v.expand((n,) + tuple(v.shape)).clone() for name, v in self.initial_chain_state.items()}
        for sampler in self.samplers:
            if sampler.param not in chain_state:
                prior = sampler.model[sampler.param]
                key = gmrf.Key(generator)
                chain_state[sampler.param] = prior.sample(key, self._full_state(chain_state), n=1, batch_shape=(n,))
        return chain_state

    def _log_dets(self) -> Dict[str, float]:
        """log|P| of every Normal's ScaledMatrix matrix that is data: constant for
        the run, so taken once on the host instead of once per stored draw."""
        out = {}
        for name, dist in self.model.items():
            if isinstance(dist, Normal) and isinstance(dist.precision, ScaledMatrix) and dist.precision.matrix in self.data:
                out[name] = dist.unscaled_log_det(self.data)
        return out

    def _init_stats(self, chain_state: dict) -> dict:
        """Every sampler's ``init_stats()`` with a leading chain axis, on the
        driver's device, plus the carried log-density of the initial state for
        the samplers :meth:`_carried_logp_params` names."""
        n = self.n_chains
        stats = {s.param: {k: v.to(self.device).expand((n,) + tuple(v.shape)).clone() for k, v in s.init_stats().items()}
                 for s in self.samplers}
        full = self._full_state(chain_state)
        for s in self.samplers:
            if s.param in self._carry_logp:
                stats[s.param]["logp"] = s.initial_carried_logp(full)
        return stats

    def _sweep(self, generator, seed: int, sweep: int, chain_state: dict, stats: dict, adapt: bool):
        """One pass over all samplers. Sampler i of pass ``sweep`` gets Philox call
        counter sweep * len(samplers) + i: host integers, no read from the card."""
        full = self._full_state(chain_state)
        for i, sampler in enumerate(self.samplers):
            key = gmrf.Key(generator, seed, sweep * len(self.samplers) + i)
            full, stats[sampler.param] = sampler.step(key, full, stats[sampler.param], adapt=adapt)
        return {name: full[name] for name in self.chain_state_names}

    def _record(self, chain_state: dict, log_dets: dict) -> dict:
        full = self._full_state(chain_state)
        out = {name: chain_state[name] for name in self.store_names if name in chain_state}
        out["log_post"] = self.model.log_p(full, log_dets)
        if self.model.response is not None:
            for response, predictor_name in self.model.response.items():
                predictor = getattr(self.model[response], predictor_name)
                out[f"{response}_fitted"] = predictor.predictor(full)
        return out

    def _run_generic(self) -> MCMCResult:
        """Burn-in, then n_iter stored iterations, each n_thin passes over the
        samplers (burn-in iterations too, as in the JAX package). The store is
        preallocated as (chains, n_iter, ...) and filled in place."""
        generator = torch.Generator(device=self.device).manual_seed(self.seed)
        seed = self.seed & 0x7FFFFFFF
        chain_state = self._init_chain_state(generator)
        stats = self._init_stats(chain_state)
        log_dets = self._log_dets()
        sweep = 0
        for _ in range(self.n_burn * self.n_thin):
            chain_state = self._sweep(generator, seed, sweep, chain_state, stats, adapt=True)
            sweep += 1
        store = {}
        for t in range(self.n_iter):
            for _ in range(self.n_thin):
                chain_state = self._sweep(generator, seed, sweep, chain_state, stats, adapt=False)
                sweep += 1
            for name, value in self._record(chain_state, log_dets).items():
                if name not in store:
                    shape = (self.n_chains, self.n_iter) + tuple(value.shape[1:] if name == "log_post" else value.shape[-2:])
                    store[name] = torch.empty(shape, dtype=value.dtype, device=self.device)
                store[name][:, t] = value
        log_post = store.pop("log_post")
        return MCMCResult(store=store, log_post=log_post, stats=stats, final_state=chain_state)

    # -- fused engines ---------------------------------------------------------

    def _fused_fitted(self, store: dict) -> dict:
        """Fitted values of fused runs, recomputed from the stored draws.

        Every predictor the port has (``Identity``, ``LinearCombination``)
        broadcasts over leading axes, so it evaluates on the (chains,
        draws)-batched store directly: X (N, p) @ beta (chains, draws, p, 1) is
        (chains, draws, N, 1), what the JAX package's vmap over chains and draws
        computes."""
        if self.model.response is None:
            return {}
        available = set(self.data) | set(store)
        full = {**self.data, **store}
        fitted = {}
        for response, predictor_name in self.model.response.items():
            predictor = getattr(self.model[response], predictor_name)
            if not set(predictor.get_param_list()) <= available:
                continue
            fitted[f"{response}_fitted"] = predictor.predictor(full)
        return fitted

    def _run_fused(self, runner, bit_source=None) -> MCMCResult:
        """Execute a matched fused engine and repackage it as an MCMCResult."""
        seed = self.seed & 0x7FFFFFFF
        store, log_post, stats = runner(seed, bit_source=bit_source)
        final_state = {name: draws[:, -1] for name, draws in store.items()}
        declared = getattr(runner, "store_keys", None)
        if declared is not None and not declared <= set(store):
            raise RuntimeError(
                f"fused engine {runner.engine_name}: declared store_keys {sorted(declared - set(store))} "
                f"missing from the returned store {sorted(store)}"
            )
        fitted = self._fused_fitted(store)
        store = {name: draws for name, draws in store.items() if name in self.store_names}
        store.update(fitted)
        return MCMCResult(store=store, log_post=log_post, stats=stats, final_state=final_state,
                          engine=runner.engine_name)
