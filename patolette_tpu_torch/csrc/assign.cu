// K3: nearest centre for channel-planar pixels.
//
// Replaces patolette_tpu/ops/assign.py::assign_planar (and the blocks of
// assign): the JAX package built a (chunk, K) distance matrix from three
// rank-1 products on the TPU's vector unit; here each thread keeps its
// pixels' running minimum in registers and nothing of size N x K exists.
//
// d = |c|^2 - 2 ((xa ca + xb cb) + xc cc), every op rounded on its own
// (__fmul_rn/__fadd_rn, so nvcc cannot contract a pair into an FMA and
// change the rounding against the plain version); invalid slots are
// skipped; a slot replaces the best only when strictly smaller, so ties go
// to the lowest index, as jnp.argmin does.
//
// Bound on the H100: f32 operations. Seven per (pixel, centre): at the 4K
// direct map (N = 8,294,400, K = 256) 14.9 GFLOP, ~0.22 ms at 67 TFLOP/s,
// against 133 MB of pixel and label traffic (~0.04 ms).
//
// Design: centres with |c|^2 and the valid flag sit in shared memory, in
// tiles of kTile when K is large; each thread owns kPix pixels (strided by
// the block size, so loads stay coalesced) and reuses every centre it
// reads from shared memory kPix times.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kPix = 8;

__global__ void assign_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              const float* __restrict__ c,
                              const float4* __restrict__ cent,
                              const int* __restrict__ valid, int n, int k,
                              int* __restrict__ labels) {
  __shared__ float4 sc[kTile];
  __shared__ int sv[kTile];
  const size_t base = (size_t)blockIdx.x * blockDim.x * kPix + threadIdx.x;
  float xa[kPix], xb[kPix], xc[kPix], best[kPix];
  int lbl[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const size_t q = base + (size_t)j * blockDim.x;
    const bool in = q < (size_t)n;
    xa[j] = in ? a[q] : 0.0f;
    xb[j] = in ? b[q] : 0.0f;
    xc[j] = in ? c[q] : 0.0f;
    best[j] = INFINITY;
    lbl[j] = 0;
  }
  for (int t0 = 0; t0 < k; t0 += kTile) {
    const int cnt = min(kTile, k - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      sc[i] = cent[t0 + i];
      sv[i] = valid[t0 + i];
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      if (!sv[i]) continue;
      const float4 cc = sc[i];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const float d = pt_dist(xa[j], xb[j], xc[j], cc);
        if (d < best[j]) {
          best[j] = d;
          lbl[j] = t0 + i;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const size_t q = base + (size_t)j * blockDim.x;
    if (q < (size_t)n) labels[q] = lbl[j];
  }
}

}  // namespace

// cent: (K, 4) rows [c0, c1, c2, |c|^2]; valid: (K,) int32; labels: (N,).
PT_EXPORT int pt_assign_planar(const float* a, const float* b, const float* c,
                               const float* cent, const int* valid, int n,
                               int k, int* labels, void* stream) {
  const int threads = 256;
  const long long per_block = (long long)threads * kPix;
  const int blocks = (int)((n + per_block - 1) / per_block);
  assign_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      a, b, c, (const float4*)cent, valid, n, k, labels);
  return (int)cudaGetLastError();
}
