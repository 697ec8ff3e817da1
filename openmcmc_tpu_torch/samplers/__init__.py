"""Samplers. Ported so far: the conjugate NormalNormal, NormalGamma and
MixtureAllocation, and the Metropolis family (RandomWalk, RandomWalkLoop,
ManifoldMALA)."""

from openmcmc_tpu_torch.samplers.base import Sampler
from openmcmc_tpu_torch.samplers.conjugate import MixtureAllocation, NormalGamma, NormalNormal
from openmcmc_tpu_torch.samplers.metropolis import (
    ManifoldMALA,
    MetropolisHastings,
    RandomWalk,
    RandomWalkLoop,
    acceptance_rate,
)

__all__ = ["Sampler", "NormalNormal", "NormalGamma", "MixtureAllocation", "MetropolisHastings", "RandomWalk", "RandomWalkLoop",
           "ManifoldMALA", "acceptance_rate"]
