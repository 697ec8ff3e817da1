"""Fused whole-run sampling engines. Ported so far: the spectral GMRF smoother
(kernel K1), the Thomas-scan GMRF smoother with its box-truncated variant
(kernel K4), linear regression with an unrolled Cholesky (kernel K6) and in
eigencoordinates (kernel K5), random-walk Metropolis (kernel K7), constant-metric
manifold MALA with a precomputed Cholesky (kernel K8) and in eigencoordinates
(kernel K9), the Gaussian-mixture Gibbs run (kernel K10), the reversible-jump
knot-basis regression (kernel K11), and the random-number layer they draw from
(K2)."""

from openmcmc_tpu_torch.fused.gmrf_smoother import run_fused_smoother
from openmcmc_tpu_torch.fused.linreg import run_fused_linreg
from openmcmc_tpu_torch.fused.mixture import run_fused_mixture
from openmcmc_tpu_torch.fused.mmala import run_fused_mmala
from openmcmc_tpu_torch.fused.random_walk import run_fused_rw
from openmcmc_tpu_torch.fused.rj import run_fused_rj
from openmcmc_tpu_torch.fused.spectral import run_spectral_linreg, run_spectral_mmala, run_spectral_smoother

__all__ = ["run_fused_linreg", "run_fused_mixture", "run_fused_mmala", "run_fused_rj", "run_fused_rw", "run_fused_smoother",
           "run_spectral_linreg", "run_spectral_mmala", "run_spectral_smoother"]
