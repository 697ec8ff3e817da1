"""Fused whole-run sampling engines. Ported so far: the spectral GMRF smoother
(kernel K1), the Thomas-scan GMRF smoother with its box-truncated variant
(kernel K4), and the random-number layer they draw from (K2)."""

from openmcmc_tpu_torch.fused.gmrf_smoother import run_fused_smoother
from openmcmc_tpu_torch.fused.spectral import run_spectral_smoother

__all__ = ["run_fused_smoother", "run_spectral_smoother"]
