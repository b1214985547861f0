// The nearest-centre scan shared by K3 (labels of image pixels) and K5 (the
// 24-bit table over the ICtCp grid of every uint8 sRGB code): one kernel,
// templated on the label type, so the table and the direct map agree bit
// for bit by construction.
//
// d = |c|^2 - 2 ((xa ca + xb cb) + xc cc) (pt_dist, every op rounded on its
// own); invalid slots are skipped; a slot replaces the best only when
// strictly smaller, so ties go to the lowest index, as jnp.argmin does.
//
// Design: centres with |c|^2 and the valid flag sit in shared memory, in
// tiles of kNearestTile when K is large; each thread owns kNearestPix
// points (strided by the block size, so loads and stores stay coalesced)
// and reuses every centre it reads from shared memory kNearestPix times.
#pragma once

#include "common.cuh"

namespace {

constexpr int kNearestTile = 1024;
constexpr int kNearestPix = 8;
constexpr int kNearestThreads = 256;

template <typename Label>
__global__ void nearest_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               const float* __restrict__ c,
                               const float4* __restrict__ cent,
                               const int* __restrict__ valid, int n, int k,
                               Label* __restrict__ labels) {
  __shared__ float4 sc[kNearestTile];
  __shared__ int sv[kNearestTile];
  const size_t base =
      (size_t)blockIdx.x * blockDim.x * kNearestPix + threadIdx.x;
  float xa[kNearestPix], xb[kNearestPix], xc[kNearestPix], best[kNearestPix];
  int lbl[kNearestPix];
#pragma unroll
  for (int j = 0; j < kNearestPix; ++j) {
    const size_t q = base + (size_t)j * blockDim.x;
    const bool in = q < (size_t)n;
    xa[j] = in ? a[q] : 0.0f;
    xb[j] = in ? b[q] : 0.0f;
    xc[j] = in ? c[q] : 0.0f;
    best[j] = INFINITY;
    lbl[j] = 0;
  }
  for (int t0 = 0; t0 < k; t0 += kNearestTile) {
    const int cnt = min(kNearestTile, k - t0);
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
      for (int j = 0; j < kNearestPix; ++j) {
        const float d = pt_dist(xa[j], xb[j], xc[j], cc);
        if (d < best[j]) {
          best[j] = d;
          lbl[j] = t0 + i;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNearestPix; ++j) {
    const size_t q = base + (size_t)j * blockDim.x;
    if (q < (size_t)n) labels[q] = (Label)lbl[j];
  }
}

// cent: (K, 4) rows [c0, c1, c2, |c|^2]; valid: (K,) int32; labels: (N,).
template <typename Label>
int launch_nearest(const float* a, const float* b, const float* c,
                   const float* cent, const int* valid, int n, int k,
                   Label* labels, void* stream) {
  const long long per_block = (long long)kNearestThreads * kNearestPix;
  const int blocks = (int)((n + per_block - 1) / per_block);
  if (blocks == 0) return 0;
  nearest_kernel<Label><<<blocks, kNearestThreads, 0, (cudaStream_t)stream>>>(
      a, b, c, (const float4*)cent, valid, n, k, labels);
  return (int)cudaGetLastError();
}

}  // namespace
