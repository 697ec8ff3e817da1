"""Distribution library. Ported so far: Normal, Gamma and Categorical."""

from openmcmc_tpu_torch.distributions.base import Distribution
from openmcmc_tpu_torch.distributions.location_scale import LocationScale, Normal
from openmcmc_tpu_torch.distributions.univariate import Categorical, Gamma

__all__ = ["Distribution", "LocationScale", "Normal", "Gamma", "Categorical"]
