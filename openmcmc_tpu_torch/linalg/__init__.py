"""Structured linear algebra for GMRF models, and the special samplers."""

from openmcmc_tpu_torch.linalg import gamma, gmrf, random, structured
from openmcmc_tpu_torch.linalg.random import fast_gamma
from openmcmc_tpu_torch.linalg.structured import Banded, Dense, Diagonal, as_structured

__all__ = ["gamma", "gmrf", "random", "structured", "fast_gamma", "Dense", "Diagonal", "Banded", "as_structured"]
