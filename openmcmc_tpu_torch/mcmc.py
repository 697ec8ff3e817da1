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
seeded from the run's seed (torch draws: Gamma variates, prior init,
non-tridiagonal Normal noise, truncated-normal uniforms, Metropolis proposals
and accept uniforms, mixture allocations, reversible-jump move types and
deletion indices), and K3 from Philox keyed by ``seed & 0x7FFFFFFF`` with a call
counter per (sweep, sampler). The streams differ from the JAX package's
threefry ones; its draws agree in distribution.

Operations: ``run(resume=...)`` continues a result's chains (no prior
initialisation, no burn-in) from its ``final_state`` and ``stats``, on the
stream of its ``final_key``: the seed the next run of those chains draws from,
advanced on every run by :func:`next_key`. :meth:`MCMC.run_chunked` splits a
run into resumed chunks with progress, checkpoints (``checkpoint.py``) and
host offload. The fused engines resume from per-chain warm rows where their
kernels take them (K1, K4, K5, K6, K11); the random-walk, mMALA and mixture
engines do not yet, and ``engine="auto"`` resumes them in the generic driver.

Not ported yet: a float64 mode in place of ``jax.enable_x64`` (state is
float32; ROADMAP.md queue 1: operations).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from openmcmc_tpu_torch.distributions.location_scale import Normal
from openmcmc_tpu_torch.linalg import gmrf
from openmcmc_tpu_torch.linalg import structured as st
from openmcmc_tpu_torch.model import Model
from openmcmc_tpu_torch.parameters import ScaledMatrix
from openmcmc_tpu_torch.samplers.base import Sampler
from openmcmc_tpu_torch.utils import profiling

_MASK31 = 0x7FFFFFFF
# odd multipliers: each product is a bijection modulo 2^31, as is x ^ (x >> 16)
_KEY_MULS = (0x2C1B3C6D, 0x297A2D39)
_PIN_CAP = 4  # data generations a driver keeps pinned for its cached matches (LRU)


def _mix31(x: int) -> int:
    """An invertible avalanche mix of 31-bit integers (xor-shift-multiply)."""
    for m in _KEY_MULS:
        x ^= x >> 16
        x = (x * m) & _MASK31
    return x ^ (x >> 16)


def _unmix31(x: int) -> int:
    """The inverse of :func:`_mix31`."""
    for m in reversed(_KEY_MULS):
        x ^= x >> 16
        x = (x * pow(m, -1, 1 << 31)) & _MASK31
    return x ^ (x >> 16)


def next_key(seed: int) -> int:
    """The seed that the next run of a run's chains draws from, given that run's
    seed: the seed is read as a position on one cycle through every 31-bit
    value (the inverse of an invertible mix), stepped by one and mixed again.
    It never returns its argument (masked to 31 bits), successive keys repeat
    only after 2^31 runs, and neighbouring seeds land far apart (next_key(0)
    is not a small seed). The counterpart of the JAX package's
    ``split(fold_in(run_key, 1), n_chains)``; one seed serves all chains, since
    the port's streams carry the chain in their counters."""
    return _mix31((_unmix31(int(seed) & _MASK31) + 1) & _MASK31)


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
    sampler's are empty); final_key is the seed a resume of these chains draws
    from (:func:`next_key` of this run's seed). Together final_state, stats and
    final_key are the carry that ``MCMC.run(resume=...)`` continues and
    ``checkpoint.save_checkpoint`` persists."""

    store: Dict[str, torch.Tensor]
    log_post: torch.Tensor
    stats: Dict[str, dict]
    final_state: Dict[str, torch.Tensor]
    final_key: int
    #: which execution path produced this result: "generic" or a fused engine name
    engine: str = "generic"

    @property
    def acceptance(self) -> Dict[str, torch.Tensor]:
        """Per Metropolis sampler, the percentage of proposals accepted per chain."""
        from openmcmc_tpu_torch.samplers.metropolis import acceptance_rate

        return {name: acceptance_rate(s) for name, s in self.stats.items() if "proposal" in s}

    def print_acceptance(self) -> None:
        """Print each Metropolis sampler's acceptance rate, averaged over chains."""
        for name, rate in self.acceptance.items():
            print(f"{name}: Acceptance rate {float(torch.mean(rate.double())):.0f}%")


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
        chain_state_names: extra per-chain entries. Initial values are shared
            by every chain: a leading chain axis is not read as one value per
            chain (per-chain starting states come from ``run(resume=...)``).
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
        self._match_cache = {}
        self._data_pins = {}
        self._progress_every = None
        self._progress_callback = None
        #: the fused engine the last fused run used (None before any)
        self.last_engine = None

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

    def _run_config_key(self) -> tuple:
        """Hashable snapshot of every driver attribute a cached fused match
        bakes in: chain count, burn-in, stored iterations, thinning, the store
        set, the fitted responses, the device, the model's distributions by
        identity, and the data and initial-state entries by identity (and a
        tensor's in-place version counter).

        Each data generation is pinned on the object, so that a freed tensor's
        id is never reused by a later binding; the pins are LRU-bounded
        (``_PIN_CAP`` generations), and evicting one drops the matches built on
        it. The sampler list is construction-time state."""
        data_key = tuple(
            (k, id(v), getattr(v, "_version", None))
            for k, v in (*self.data.items(), *self.initial_chain_state.items())
        )
        if data_key in self._data_pins:
            self._data_pins[data_key] = self._data_pins.pop(data_key)  # refresh the LRU order
        else:
            self._data_pins[data_key] = (tuple(self.data.values()), tuple(self.initial_chain_state.values()))
            while len(self._data_pins) > _PIN_CAP:
                evicted = next(iter(self._data_pins))
                del self._data_pins[evicted]
                self._match_cache = {k: v for k, v in self._match_cache.items() if k[-1] != evicted}
        response = self.model.response
        return (
            self.n_chains,
            self.n_burn,
            self.n_iter,
            self.n_thin,
            tuple(self.store_names),
            None if response is None else tuple(sorted(response.items())),
            str(self.device),
            tuple((k, id(v)) for k, v in self.model.items()),
            data_key,
        )

    @profiling.traced(profiling.RUN)
    def run(self, resume: Optional[MCMCResult] = None, engine: str = "generic", progress_every: Optional[int] = None,
            progress_callback=None, bit_source=None) -> MCMCResult:
        """Run burn-in and sampling for all chains.

        ``resume``: a previous result (or one restored by
        ``checkpoint.load_checkpoint``) whose chains continue from its final
        state and statistics, on the stream of its ``final_key``: no prior
        initialisation and no burn-in, n_iter further stored iterations, the
        accept and proposal counters accumulating on top of the resumed ones.

        ``engine``: "generic" (default) runs the samplers sweep by sweep; "auto"
        runs the fused engine that structurally matches the model and samplers
        (the whole run in one kernel launch on a CUDA device) and falls back to
        the generic driver otherwise; "fused" requires a match. The match is
        cached per run configuration (:meth:`_run_config_key`); a resume
        re-matches. A resume runs fused only where the engine's kernel takes
        per-chain warm rows (the smoothers, linear regression, reversible jump
        when the result holds its padded parameters); otherwise "auto" resumes
        in the generic driver and "fused" raises.

        ``progress_every``: call ``progress_callback(done, total)`` (by default
        a printed line) every that many stored iterations of the generic
        driver's sweep loop. A fused run is one launch and reports nothing in
        flight; :meth:`run_chunked` reports per chunk.

        ``bit_source(sweep, site, shape) -> uint32 bits`` replaces the fused
        engines' Philox bits; it takes a CPU driver and a fused engine only (the
        port of the JAX package's ``prng.host_bits``, used to feed both packages
        the same bits)."""
        if engine not in ("generic", "auto", "fused"):
            raise ValueError("engine must be 'generic', 'auto' or 'fused'")
        profiling.count("mcmc.runs")
        self._progress_every = progress_every
        self._progress_callback = progress_callback
        if resume is not None:
            for name, value in resume.final_state.items():
                if value.dim() == 0 or value.shape[0] != self.n_chains:
                    raise ValueError(f"resume: final_state[{name!r}] of shape {tuple(value.shape)} does not lead "
                                     f"with the {self.n_chains} chains")
        if engine in ("auto", "fused"):
            from openmcmc_tpu_torch.fused.dispatch import match_fused_engine

            with profiling.trace_annotated("mcmc.match"):
                if resume is None:
                    key = self._run_config_key()
                    hit = key in self._match_cache
                    if not hit:
                        self._match_cache[key] = match_fused_engine(self)
                    runner = self._match_cache[key]
                else:
                    hit, runner = False, match_fused_engine(self, resume=resume)
                profiling.annotate(hit=hit)
            if runner is not None:
                return self._run_fused(runner, bit_source, resume)
            if engine == "fused":
                if resume is not None:
                    raise ValueError(
                        "engine='fused': no fused engine supports resume for this configuration (only kernels with "
                        "per-chain warm-start inputs can continue a run); use engine='generic' or 'auto' to resume"
                    )
                raise ValueError("engine='fused': no fused engine matches this model/sampler configuration")
        if bit_source is not None:
            raise ValueError("bit_source replaces a fused engine's bits; the generic driver draws from its generator")
        profiling.annotate(engine="generic")
        return self._run_generic(resume)

    def run_mcmc(self) -> MCMCResult:
        """Run, then print the Metropolis acceptance rates, as the reference's
        ``run_mcmc`` does at the end of every run. :meth:`run` stays silent."""
        result = self.run()
        result.print_acceptance()
        return result

    def run_chunked(self, n_chunks: int, checkpoint_path: Optional[str] = None, progress: bool = True,
                    engine: str = "generic", offload: bool = False) -> MCMCResult:
        """Run n_iter stored iterations as ``n_chunks`` runs, each resuming the
        one before it: burn-in runs in the first chunk, and every later chunk is
        ``run(resume=previous)`` on the previous chunk's ``final_key``.

        n_iter must be divisible by n_chunks. After every chunk: a progress line
        (``progress``), and the carry written to ``checkpoint_path`` (an
        ``.npz`` path; ``checkpoint.save_checkpoint``). ``engine`` is passed to
        :meth:`run`: "auto" runs each chunk as one fused launch where the engine
        resumes. ``offload=True`` moves each chunk's draws to host memory as it
        completes (and, with a checkpoint path, to
        ``{checkpoint_path}.chunkNNN.npz`` shards), so the device holds one
        chunk's store at a time; the result's store and log_post are then CPU
        tensors (the JAX package returns numpy arrays there)."""
        from openmcmc_tpu_torch.checkpoint import check_path, save_checkpoint

        if self.n_iter % n_chunks != 0:
            raise ValueError("n_iter must be divisible by n_chunks")
        if checkpoint_path is not None:
            check_path(checkpoint_path)
        chunk_iter = self.n_iter // n_chunks
        n_iter_full, self.n_iter = self.n_iter, chunk_iter
        result: Optional[MCMCResult] = None
        stores, log_posts = [], []
        try:
            t0 = time.perf_counter()
            for chunk in range(n_chunks):
                result = self.run(resume=result, engine=engine)
                store, log_post = result.store, result.log_post
                if offload:
                    store = {k: v.cpu() for k, v in store.items()}
                    log_post = log_post.cpu()
                    if checkpoint_path is not None:
                        np.savez(f"{checkpoint_path}.chunk{chunk:03d}.npz", log_post=log_post.numpy(),
                                 **{k: v.numpy() for k, v in store.items()})
                stores.append(store)
                log_posts.append(log_post)
                if checkpoint_path is not None:
                    save_checkpoint(checkpoint_path, result)
                if progress:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    done = (chunk + 1) * chunk_iter
                    rate = done / (time.perf_counter() - t0)
                    print(f"[openmcmc_tpu_torch] {done}/{n_iter_full} iterations ({self.n_chains} chains, "
                          f"{rate:.1f} it/s)", flush=True)
        finally:
            self.n_iter = n_iter_full
        return MCMCResult(
            store={name: torch.cat([s[name] for s in stores], dim=1) for name in stores[0]},
            log_post=torch.cat(log_posts, dim=1), stats=result.stats, final_state=result.final_state,
            final_key=result.final_key, engine=result.engine,
        )

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

    def _init_stats(self, chain_state: Optional[dict]) -> dict:
        """Every sampler's ``init_stats()`` with a leading chain axis, on the
        driver's device, plus (given a chain state) the carried log-density of
        that state for the samplers :meth:`_carried_logp_params` names."""
        n = self.n_chains
        stats = {s.param: {k: v.to(self.device).expand((n,) + tuple(v.shape)).clone() for k, v in s.init_stats().items()}
                 for s in self.samplers}
        if chain_state is None:
            return stats
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

    def _resume_carry(self, resume: MCMCResult):
        """The chain state and statistics a resume continues from, copied onto
        the driver's device. Statistics start from every sampler's
        ``init_stats()`` and take the resumed values over them; the carried
        log-densities are reconciled with this run's sweep: a stale ``logp`` is
        dropped, and a missing one is seeded from the resumed state."""
        missing = [name for name in self.chain_state_names if name not in resume.final_state]
        if missing:
            raise ValueError(f"resume: final_state has no {missing}; the generic driver continues every sampled entry "
                             f"{self.chain_state_names}")
        chain_state = {name: resume.final_state[name].to(self.device).clone() for name in self.chain_state_names}
        stats = self._init_stats(None)
        full = self._full_state(chain_state)
        for s in self.samplers:
            sampler_stats = stats[s.param]
            for k, v in resume.stats.get(s.param, {}).items():
                sampler_stats[k] = v.to(self.device).clone()
            if s.param in self._carry_logp:
                if "logp" not in sampler_stats:
                    sampler_stats["logp"] = s.initial_carried_logp(full)
            else:
                sampler_stats.pop("logp", None)
        return chain_state, stats

    def _emit_progress(self, done: int) -> None:
        callback = self._progress_callback or (
            lambda it, total: print(f"[openmcmc_tpu_torch] {it}/{total} iterations", flush=True)
        )
        callback(done, self.n_iter)

    def _run_generic(self, resume: Optional[MCMCResult] = None) -> MCMCResult:
        """Burn-in, then n_iter stored iterations, each n_thin passes over the
        samplers (burn-in iterations too, as in the JAX package); a resume
        starts from the resumed carry with no burn-in. The store is
        preallocated as (chains, n_iter, ...) and filled in place."""
        run_seed = self.seed if resume is None else int(resume.final_key)
        generator = torch.Generator(device=self.device).manual_seed(run_seed)
        seed = run_seed & _MASK31
        if resume is None:
            chain_state = self._init_chain_state(generator)
            stats = self._init_stats(chain_state)
            n_burn = self.n_burn
        else:
            chain_state, stats = self._resume_carry(resume)
            n_burn = 0
        log_dets = self._log_dets()
        every = self._progress_every
        sweep = 0
        for _ in range(n_burn * self.n_thin):
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
            if every and (t + 1) % every == 0:
                self._emit_progress(t + 1)
        log_post = store.pop("log_post")
        return MCMCResult(store=store, log_post=log_post, stats=stats, final_state=chain_state,
                          final_key=next_key(run_seed))

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

    def _run_fused(self, runner, bit_source=None, resume: Optional[MCMCResult] = None) -> MCMCResult:
        """Execute a matched fused engine and repackage it as an MCMCResult.

        The kernel's Philox key is the run's seed masked to 31 bits: ``seed``,
        or the resumed result's ``final_key``, never ``seed`` again on a resume.
        ``final_state`` is read from the runner's whole store, before the
        ``store_names`` filter."""
        run_seed = self.seed if resume is None else int(resume.final_key)
        profiling.annotate(engine=runner.engine_name)
        store, log_post, stats = runner(run_seed & _MASK31, bit_source=bit_source)
        with profiling.trace_annotated("mcmc.repackage"):
            final_state = {name: draws[:, -1] for name, draws in store.items()}
            self.last_engine = runner.engine_name
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
                              final_key=next_key(run_seed), engine=runner.engine_name)
