// K8: Riemersma error-diffusion scan along the Hilbert curve.
//
// Replaces patolette_tpu/models/dither.py::_dither_scan_core (with its
// planar feed _dither_stream_planar). The curve is cut into lanes of `seg`
// pixels (the last one short); each lane is a serial chain: the pixel is
// corrected by the 16-deep error queue (oldest first, weights w_q), scaled
// by the luma channel weights, matched to the nearest palette entry
// (d = ps2 - 2 ((pa q0 + pb q1) + pc q2), invalid entries at ps2 = +inf,
// lowest index on ties), and its uncorrected error px - palette[idx] is
// pushed, unclamped. The queue starts at zero in every lane.
//
// Not carried over from the TPU version: the step-major transpose of the
// permutation (a warp reads its pixels through the permutation itself), the
// one-hot matmul colour selection (the palette is indexed) and the unroll.
//
// Design: one warp per lane. Every thread of the warp holds the whole
// queue in registers (48 floats) and computes the correction redundantly,
// so no step needs a broadcast; the K-way argmin is split across the warp
// (entry e to thread e % 32) and reduced with shuffles that carry the
// index. The palette table sits in shared memory, whole when it fits and
// otherwise walked in tiles with the block in step. Pixels come in batches
// of 32: thread t reads perm[i + t] and the pixel's three channels, and
// step j takes them from thread j with a shuffle; thread j keeps step j's
// index and writes out[perm[i + j]] after the batch. Every product and
// sum is rounded on its own (__fmul_rn/__fadd_rn), the queue sum in one
// fixed order (q = 0..15), so the labels equal the plain version's.
//
// Bound on the H100: f32 operations, 7 per (pixel, palette entry): at 4K,
// K = 256, 14.9 GFLOP, ~0.22 ms at 67 TFLOP/s; plus a serial chain of
// `seg` dependent steps per lane (4096 at the default), whose latency
// (queue sum, argmin, shuffle reduction) is what this design pays.
#include "common.cuh"

namespace {

constexpr int kQueue = 16;
constexpr int kWarps = 4;      // lanes per block
constexpr int kTile = 2048;    // palette entries per shared-memory tile

// table rows: [pa, pb, pc, ps2] [r0, r1, r2, 0]
__device__ __forceinline__ void load_tile(float4* spal,
                                          const float4* __restrict__ table,
                                          int t0, int cnt) {
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    spal[2 * e] = table[2 * (size_t)(t0 + e)];
    spal[2 * e + 1] = table[2 * (size_t)(t0 + e) + 1];
  }
}

__global__ void dither_kernel(const float* __restrict__ x0,
                              const float* __restrict__ x1,
                              const float* __restrict__ x2,
                              const int* __restrict__ perm,
                              const float4* __restrict__ table,
                              const float* __restrict__ params, int n, int k,
                              int seg, int lanes, int* __restrict__ out) {
  extern __shared__ float4 spal[];  // min(k, kTile) * 2
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long start = (long long)lane * seg;
  const int len = lane < lanes ? (int)min((long long)seg, n - start) : 0;
  const bool resident = k <= kTile;
  if (resident) {
    load_tile(spal, table, 0, k);
    __syncthreads();
    if (len == 0) return;  // no block-wide barrier follows
  }
  // With the palette resident a warp stops at its lane's end; otherwise
  // every warp runs all `seg` steps (work past its length is discarded),
  // so the block stays in step for the tiled palette walk.
  const int total = resident ? len : seg;

  float qw[kQueue];
#pragma unroll
  for (int q = 0; q < kQueue; ++q) qw[q] = params[q];
  const float cw0 = params[kQueue], cw1 = params[kQueue + 1],
              cw2 = params[kQueue + 2];
  float qa[kQueue], qb[kQueue], qc[kQueue];
#pragma unroll
  for (int q = 0; q < kQueue; ++q) qa[q] = qb[q] = qc[q] = 0.0f;

  for (int b0 = 0; b0 < total; b0 += 32) {
    const int i = b0 + t;
    const bool mine = i < len;
    const int pix = mine ? perm[start + i] : 0;
    const float p0 = mine ? x0[pix] : 0.0f;
    const float p1 = mine ? x1[pix] : 0.0f;
    const float p2 = mine ? x2[pix] : 0.0f;
    int my_idx = 0;
    const int steps = min(32, total - b0);
    for (int j = 0; j < steps; ++j) {
      const float px0 = __shfl_sync(0xffffffffu, p0, j);
      const float px1 = __shfl_sync(0xffffffffu, p1, j);
      const float px2 = __shfl_sync(0xffffffffu, p2, j);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int q = 0; q < kQueue; ++q) {
        a0 = __fadd_rn(a0, __fmul_rn(qw[q], qa[q]));
        a1 = __fadd_rn(a1, __fmul_rn(qw[q], qb[q]));
        a2 = __fadd_rn(a2, __fmul_rn(qw[q], qc[q]));
      }
      const float q0 = __fmul_rn(__fadd_rn(px0, a0), cw0);
      const float q1 = __fmul_rn(__fadd_rn(px1, a1), cw1);
      const float q2 = __fmul_rn(__fadd_rn(px2, a2), cw2);

      float best = INFINITY;
      int bi = k;  // "none"
      for (int t0 = 0; t0 < k; t0 += kTile) {
        const int cnt = min(kTile, k - t0);
        if (!resident) {
          __syncthreads();
          load_tile(spal, table, t0, cnt);
          __syncthreads();
        }
        for (int e = t; e < cnt; e += 32) {
          const float d = pt_dist(q0, q1, q2, spal[2 * e]);
          if (d < best) {
            best = d;
            bi = t0 + e;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob < best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (bi == k) bi = 0;  // every distance +inf: argmin's first index
      const float4 raw =
          resident ? spal[2 * bi + 1] : table[2 * (size_t)bi + 1];
#pragma unroll
      for (int q = 0; q < kQueue - 1; ++q) {
        qa[q] = qa[q + 1];
        qb[q] = qb[q + 1];
        qc[q] = qc[q + 1];
      }
      qa[kQueue - 1] = __fsub_rn(px0, raw.x);
      qb[kQueue - 1] = __fsub_rn(px1, raw.y);
      qc[kQueue - 1] = __fsub_rn(px2, raw.z);
      if (t == j) my_idx = bi;
    }
    if (mine) out[pix] = my_idx;
  }
}

}  // namespace

// x0..x2: (n,) linear Rec2020 channels; perm: (n,) int32 visit order;
// table: (k, 8) f32 rows [pa, pb, pc, ps2, r0, r1, r2, 0]; params: the 16
// queue weights then the 3 channel weights; out: (n,) int32.
PT_EXPORT int pt_dither_scan(const float* x0, const float* x1, const float* x2,
                             const int* perm, const float* table,
                             const float* params, int n, int k, int seg,
                             int lanes, int* out, void* stream) {
  const int tile = k < kTile ? k : kTile;
  const size_t smem = (size_t)tile * 2 * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      dither_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (lanes + kWarps - 1) / kWarps;
  dither_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      x0, x1, x2, perm, (const float4*)table, params, n, k, seg, lanes, out);
  return (int)cudaGetLastError();
}
