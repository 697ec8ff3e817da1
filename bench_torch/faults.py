"""Faults planted under the timed path: ``with planted(name):`` wraps
``MCMC.run`` so that each fit's result is broken where it is produced. The
check's tests plant them at a small size on the CPU, ``calibrate.py`` at a
cell's own size on the card; the benchmark's runs never do. One chip shares
nothing across chips, so the fault of an exchange left out does not arise."""

from __future__ import annotations

import contextlib

import torch


def stuck(mcmc, result, chains: int) -> None:
    """The first ``chains`` chains' draws left at the initial state, with the log
    posterior that state has: a step that returns its state unchanged."""
    state = mcmc._init_chain_state(torch.Generator(device=mcmc.device))
    record = mcmc._record(state, mcmc._log_dets())
    for name, draws in result.store.items():
        draws[:chains] = record[name][:chains, None].to(draws.dtype)
    result.log_post[:chains] = record["log_post"][:chains, None]


def altered(mcmc, result) -> None:
    """One stored value of the latent changed where it is produced, its log
    posterior not. A model whose last coordinate the posterior may not read (a
    padded, variable-dimension state) defines its own ``altered(mcmc, result)``."""
    result.store[mcmc.samplers[0].param][3, 7, -1] += 0.25


FAULTS = {
    "state_unchanged": lambda mcmc, result: stuck(mcmc, result, mcmc.n_chains),
    "half_the_chains_left_out": lambda mcmc, result: stuck(mcmc, result, mcmc.n_chains // 2),
    "a_draw_altered": altered,
}


@contextlib.contextmanager
def planted(fault: str, model=None):
    """``MCMC.run`` with ``fault`` applied to every result, inside the block;
    ``a_draw_altered`` at ``model``'s own site (``models/<model>.py``'s
    ``altered``) where it defines one."""
    from openmcmc_tpu_torch.mcmc import MCMC

    real = MCMC.run
    apply = getattr(model, "altered", FAULTS[fault]) if fault == "a_draw_altered" else FAULTS[fault]

    def broken(self, *args, **kwargs):
        result = real(self, *args, **kwargs)
        apply(self, result)
        return result

    MCMC.run = broken
    try:
        yield
    finally:
        MCMC.run = real
