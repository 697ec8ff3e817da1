"""Samplers. Ported so far: the conjugate NormalNormal, NormalGamma and
MixtureAllocation, the Metropolis family (RandomWalk, RandomWalkLoop,
ManifoldMALA) and ReversibleJump."""

from openmcmc_tpu_torch.samplers.base import Sampler
from openmcmc_tpu_torch.samplers.conjugate import MixtureAllocation, NormalGamma, NormalNormal
from openmcmc_tpu_torch.samplers.metropolis import (
    ManifoldMALA,
    MetropolisHastings,
    RandomWalk,
    RandomWalkLoop,
    acceptance_rate,
)
from openmcmc_tpu_torch.samplers.reversible_jump import ReversibleJump

__all__ = ["Sampler", "NormalNormal", "NormalGamma", "MixtureAllocation", "MetropolisHastings", "RandomWalk", "RandomWalkLoop",
           "ManifoldMALA", "ReversibleJump", "acceptance_rate"]
