// spectral_store: the stored draws of the spectral smoother, linear-regression
// and mMALA runs (spectral_smoother.cu, K1, at p <= 256; spectral_linreg.cu, K5;
// spectral_mmala.cu, K9), b = V w, computed in place over every stored row at
// once, p <= 256.
//
// Replaces the store inside the TPU kernels: the smoother's b = V w at
// openmcmc_tpu/fused/spectral.py:319 (_make_smoother_kernel) and the block product
// lax.dot_general(w, V, ...) on the MXU at :174-177 (_make_linreg_kernel) and
// :755-758 (_make_mmala_kernel). The sweep kernels write each stored sweep's w
// into the row of out where b goes; this kernel then multiplies the (rows, p)
// matrix of those rows by V' and writes b over them. Input: vt, V' padded to
// (p rounded up to kDepth, kCols): vt[k * kCols + i] = V[i, k]; the padding is
// never summed or stored, so its values do not matter.
//
// Summation order: every output is acc = fmaf(w_k, V[i, k], acc) from acc = 0
// over k = 0, 1, .., p - 1 in order (no padded k is added), the order of the
// per-chain store it replaces (spectral_store.cuh, K1's above p = 256), so b is
// the same to the bit. Full float32 on the FMA pipes: no TF32 and no split.
//
// What bounds it: operations. K1's main path (4,096,000 rows, p = 100): 2 rows p^2
// = 8.2e10 float32 FLOP, 1.22 ms at 67 TFLOP/s; its bytes (each w read once, each
// b written once, 3.3 GB) take 0.98 ms at 3.35 TB/s. K5's and K9's (2,048,000
// rows, p = 256): 2.7e11 FLOP, 4.0 ms; 4.2 GB, 1.25 ms. At 25 to 64 FLOP a byte
// the traffic hides under the FMAs once each element of V and w is reused from
// registers, which the per-chain store could not do (each FMA there loaded V from
// shared memory or L1/L2).
//
// Design: a register-tiled product. A block of kCols threads owns a strip of
// kRows rows across all kCols columns of its tile. It stages the whole strip,
// transposed, in shared memory before it writes anything, so the product can run
// in place: a block reads and writes only its own rows, which are one contiguous
// run of out. V' streams from L2 in k-tiles of kDepth rows by cp.async,
// double-buffered. Each thread keeps 8 rows x 8 columns of outputs in registers
// (columns 4 tc .. 4 tc + 3 and kCols / 2 + 4 tc .. kCols / 2 + 4 tc + 3, so a
// warp's 16-byte loads of a V' row cover consecutive banks), fed by four 16-byte
// shared loads per k: 64 FMAs for 16 floats loaded. At most 128 registers a
// thread: 512 threads an SM.
//
// The tile follows p: 128 columns up to p = 128, else 256; the columns past p
// are computed and masked. At K1's p = 100 the 256-column tile would issue 2.56
// times the useful FMAs, the 128-column one 1.28 times. Shared memory: at p = 100
// and 128 columns 43 KB, four blocks an SM; at p = 256 and 256 columns 100 KB,
// two blocks an SM.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;        // rows of out a block owns
constexpr int kDepth = 16;       // rows of V' in a k-tile
constexpr int kLdw = kRows + 4;  // pitch of the transposed strip (floats): 16-byte rows, 4-way staging writes
constexpr int kStage = 16;       // strip loads in flight a thread (the 128-column tile)

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One k: the thread's 8 rows of w at k (ws_k, transposed strip) times its 8
// columns of V' row k (vs_k). kCols: the tile's columns, and threads of a block.
template <int kCols>
__device__ __forceinline__ void fma_k(float (&acc)[8][8], const float* ws_k, const float* vs_k, int tr, int tc) {
  const float4 a0 = *reinterpret_cast<const float4*>(ws_k + 8 * tr);
  const float4 a1 = *reinterpret_cast<const float4*>(ws_k + 8 * tr + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(vs_k + 4 * tc);
  const float4 b1 = *reinterpret_cast<const float4*>(vs_k + kCols / 2 + 4 * tc);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int kCols>
__global__ void __launch_bounds__(kCols, 512 / kCols)
    spectral_store_kernel(float* __restrict__ out, const float* __restrict__ vt, int p, long long n_rows, int vec) {
  constexpr int TC = kCols / 8;  // column groups; kCols / TC = 8 row groups of 8 rows
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                     // [p][kLdw]: ws[k * kLdw + r] = w[row0 + r, k]
  float* vs = smem + (size_t)p * kLdw;  // two k-tiles of [kDepth][kCols]
  const int tid = threadIdx.x;
  const int tr = tid / TC, tc = tid % TC;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, n_rows - row0);
  const int n_tiles = (p + kDepth - 1) / kDepth;

  auto load_tile = [&](int t) {  // kDepth * kCols / 4 = 4 kCols chunks of 16 bytes, 4 a thread
    const float* src = vt + (size_t)t * kDepth * kCols;
    float* dst = vs + (t & 1) * kDepth * kCols;
#pragma unroll
    for (int c = 0; c < 4; ++c) cp_async16(dst + 4 * (tid + c * kCols), src + 4 * (tid + c * kCols));
    cp_async_commit();
  };
  load_tile(0);

  // the strip, kRows * p contiguous floats, transposed; rows past the ragged end
  // are zero. The 256-column tile's long k loop (p > 128) hides a staging of
  // dependent loads, warps over rows and lanes over k; the 128-column tile's
  // (p <= 128) does not, so it keeps kStage coalesced loads in flight a thread
  // (element j of the strip is row j / p, column j % p), then stores them. Each
  // staging is the faster at its tile: at p = 100 2.60 ms against 4.69, at
  // p = 256 5.76 against 5.95 (4,096,000 and 2,048,000 rows, H100).
  const float* strip = out + row0 * p;
  if constexpr (kCols == 256) {
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < kRows; r += kCols / 32) {
      for (int k = lane; k < p; k += 32) ws[k * kLdw + r] = r < rows ? strip[(size_t)r * p + k] : 0.0f;
    }
  } else {
    const int n_valid = rows * p, n_strip = kRows * p;
    const int q = kCols / p, rem = kCols - q * p;  // a step of kCols elements: q rows and rem columns
    int r = tid / p, k = tid - r * p;
    for (int j0 = tid; j0 < n_strip; j0 += kStage * kCols) {
      float v[kStage];
#pragma unroll
      for (int c = 0; c < kStage; ++c) {
        const int j = j0 + c * kCols;
        v[c] = j < n_valid ? strip[j] : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < kStage; ++c) {
        if (j0 + c * kCols < n_strip) ws[k * kLdw + r] = v[c];
        r += q;
        k += rem;
        if (k >= p) {
          k -= p;
          ++r;
        }
      }
    }
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);  // into the buffer every thread finished reading at t - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, the strip) is in shared memory for every thread
    const float* vs_t = vs + (t & 1) * kDepth * kCols;
    const int k0 = t * kDepth;
    if (k0 + kDepth <= p) {
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) fma_k<kCols>(acc, ws + (k0 + kk) * kLdw, vs_t + kk * kCols, tr, tc);
    } else {
      for (int kk = 0; kk < p - k0; ++kk) fma_k<kCols>(acc, ws + (k0 + kk) * kLdw, vs_t + kk * kCols, tr, tc);
    }
    __syncthreads();  // buffer t & 1 is refilled at t + 1
  }

  // beta over the strip's rows, the ragged rows and columns masked
  float* ob = out + row0 * p;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * tr + i;
    if (r >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h * (kCols / 2) + 4 * tc;
      float* dst = ob + (size_t)r * p + c;
      if (vec) {
        if (c < p) *reinterpret_cast<float4*>(dst) = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                                                 acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c + j < p) dst[j] = acc[i][4 * h + j];
        }
      }
    }
  }
}

template <int kCols>
int launch(float* out, const float* vt, int p, long long n_rows, cudaStream_t stream) {
  const size_t smem = ((size_t)p * kLdw + 2 * kDepth * kCols) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(spectral_store_kernel<kCols>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = p % 4 == 0 && ((uintptr_t)out & 15) == 0;  // 16-byte stores of whole column groups
  const unsigned blocks = (unsigned)((n_rows + kRows - 1) / kRows);
  spectral_store_kernel<kCols><<<blocks, kCols, smem, stream>>>(out, vt, p, n_rows, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// b = w V' over the n_rows contiguous rows of out (p floats each), in place; vt
// is V' padded as above to `cols` columns, the tile's: 128 or 256.
extern "C" int spectral_store_launch(float* out, const float* vt, int p, int cols, long long n_rows,
                                     cudaStream_t stream) {
  if ((cols != 128 && cols != 256) || p < 1 || p > cols || n_rows < 0 ||
      (n_rows + kRows - 1) / kRows > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_rows == 0) return 0;
  return cols == 128 ? launch<128>(out, vt, p, n_rows, stream) : launch<256>(out, vt, p, n_rows, stream);
}
