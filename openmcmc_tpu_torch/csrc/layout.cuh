// Result-layout helpers shared by the fused kernels.
#pragma once

// Stored-draw index of sweep `it`, or -1 (openmcmc_tpu/fused/layout.py:6):
// every stored draw runs n_thin sweeps after the n_burn burn-in SWEEPS, and the
// state after the n_thin-th is stored.
__device__ __forceinline__ int store_index(int it, int n_burn, int n_thin) {
  int rel = it - n_burn;
  if (rel < 0) return -1;
  if (n_thin == 1) return rel;
  return (rel % n_thin == n_thin - 1) ? rel / n_thin : -1;
}
