"""Distribution library: Normal, NullDistribution, Gamma, Poisson, Uniform and Categorical."""

from openmcmc_tpu_torch.distributions.base import Distribution
from openmcmc_tpu_torch.distributions.location_scale import LocationScale, Normal, NullDistribution
from openmcmc_tpu_torch.distributions.univariate import Categorical, Gamma, Poisson, Uniform

__all__ = ["Distribution", "LocationScale", "Normal", "NullDistribution", "Gamma", "Poisson", "Uniform",
           "Categorical"]
