"""Sampler protocol (port of ``openmcmc_tpu/samplers/base.py``).

A sampler updates one state entry. As in the JAX package, a step is
``step(key, state, stats) -> (state, stats)``, composed by the generic driver;
the key is a :class:`openmcmc_tpu_torch.linalg.gmrf.Key` (the run's
``torch.Generator`` and the Philox key and counter of kernel draws), and the
state's per-chain entries carry a leading chain axis in place of ``vmap``.
Samplers are also the structure the fused-engine dispatcher matches on.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Tuple

from openmcmc_tpu_torch.model import Model


class Sampler(ABC):
    """Abstract per-parameter sampler.

    Attributes:
        param: name of the state entry this sampler updates.
        model: sub-model restricted to the distributions depending on ``param``.
    """

    param: str
    model: Model

    def __init__(self, param: str, model: Model):
        self.param = param
        self.model = model.conditional(param)

    def init_stats(self) -> Dict:
        """Initial statistics of one chain (empty by default); the driver gives
        every entry a leading chain axis."""
        return {}

    @abstractmethod
    def step(self, key, state: dict, stats: dict, adapt: bool = False) -> Tuple[dict, dict]:
        """Draw a new value for ``self.param``; return the updated state and stats.

        ``adapt`` is True during burn-in sweeps, where samplers with a tunable
        proposal (Metropolis step sizes) adapt it; False while sampling."""
