// The store of the spectral smoother (spectral_smoother.cu, K1) above p = 256:
// one chain's stored draw b = V w, computed by its warp with lanes over field
// rows (four rows per lane in flight), each row written coalesced into ob.
// vt[k * p + i] = V[i, k] sits in global memory; wbuf holds w. Each output sums
// fmaf(V[i, k], w_k, acc) over k in ascending order, as spectral_store.cu does.
//
// What bounds it: loads. Every FMA reads V from L1/L2, and no element of V is
// reused across chains. Up to p = 256, its widest tile, K1, K5 and K9 leave it
// for spectral_store.cu, one register-tiled product over every stored row at
// once; its in-place strip of rows (p by 68 floats) would fill shared memory at
// p of about 580, far below K1's 8192.
#pragma once

__device__ __forceinline__ void store_vw(const float* __restrict__ vt, const float* wbuf, float* __restrict__ ob,
                                         int p, int lane) {
  for (int i0 = 0; i0 < p; i0 += 128) {
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
    const int i = i0 + lane;
    const bool in0 = i < p, in1 = i + 32 < p, in2 = i + 64 < p, in3 = i + 96 < p;
    for (int k = 0; k < p; ++k) {
      const float wk = wbuf[k];
      const float* row = vt + (size_t)k * p + i;
      if (in0) acc0 = fmaf(row[0], wk, acc0);
      if (in1) acc1 = fmaf(row[32], wk, acc1);
      if (in2) acc2 = fmaf(row[64], wk, acc2);
      if (in3) acc3 = fmaf(row[96], wk, acc3);
    }
    if (in0) ob[i] = acc0;
    if (in1) ob[i + 32] = acc1;
    if (in2) ob[i + 64] = acc2;
    if (in3) ob[i + 96] = acc3;
  }
}
