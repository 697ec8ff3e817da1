"""Samplers. Ported so far: the conjugate NormalNormal and NormalGamma, and the
Metropolis family (RandomWalk, RandomWalkLoop, ManifoldMALA)."""

from openmcmc_tpu_torch.samplers.base import Sampler
from openmcmc_tpu_torch.samplers.conjugate import NormalGamma, NormalNormal
from openmcmc_tpu_torch.samplers.metropolis import (
    ManifoldMALA,
    MetropolisHastings,
    RandomWalk,
    RandomWalkLoop,
    acceptance_rate,
)

__all__ = ["Sampler", "NormalNormal", "NormalGamma", "MetropolisHastings", "RandomWalk", "RandomWalkLoop",
           "ManifoldMALA", "acceptance_rate"]
