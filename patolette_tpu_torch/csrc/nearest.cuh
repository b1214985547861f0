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
// points and reuses every centre it reads from shared memory kNearestPix
// times. A warp's 256 points are, in the linear layout, 8 runs of 32
// consecutive points 256 apart (on the grid: 8 g x 32 b codes at one r); in
// the brick layout (grids only, n a multiple of 2^18), 4 r x 8 g x 8 b
// codes.
//
// Pruning. A brute-force scan does 7 rounded f32 operations per
// (point, valid centre), 1.2e11 on the 2^24 grid at K = 1024; so each warp
// first lists the centres that can win anywhere in the box of the values it
// loaded, and scans only those:
//   1. box: the min and max of a, b and c over the warp's in-range points
//      (warp reductions; NaN coordinates drop out, and a NaN point is
//      labelled 0 by either scan, as no d < best ever holds for it);
//   2. for every valid centre j: LB_j <= min over the box of |x - c_j|^2
//      (f32 rounded down), UB_j >= max over the box of |x - c_j|^2
//      (rounded up), and eta_j >= |pt_dist(x, c_j) - (|c_j|^2 - 2 x.c_j)|
//      for every x of the box (rounded up); U = min_j UB_j (running over the
//      tiles), eta_U the eta of a centre k with UB_k = U;
//   3. j is listed unless LB_j - U > eta_j + eta_U (the difference rounded
//      down, the sum up); the lanes take the centres 32 at a time, a ballot
//      and a popc prefix write each step's survivors, so the list stays in
//      index order;
//   4. the scan runs over the list alone with the same pt_dist and the same
//      strict <.
// Why nothing changes: for every point x of the box, the exact values
// satisfy (|c_j|^2 - 2 x.c_j) - (|c_k|^2 - 2 x.c_k) = |x - c_j|^2 - |x -
// c_k|^2 >= LB_j - UB_k >= LB_j - U. An excluded j thus has a computed
// distance above the computed distance of k by more than zero (the two
// rounding errors, at most eta_j + eta_U, do not close the gap), so it can
// neither win nor tie; k itself is listed (LB_k <= UB_k = U), and the
// first minimum among the listed centres, scanned in index order, is the
// first minimum among all of them. Non-finite bounds compare false and keep
// the centre, so an infinite coordinate gives the full scan.
// eta: pt_dist rounds three products, two sums, the doubling (exact) and
// the difference; |c|^2 comes from pt_norm2 (three products, two sums, all
// terms >= 0). Summing the relative errors, |computed - exact| <= (gamma_3
// + u (1 + gamma_3)) (|c|^2 + 2 sum_i |x_i| |c_i|) with u = 2^-24,
// gamma_3 = 3u / (1 - 3u), so < 4.0001 u; with |c|^2 <= c.w (1 + 4u) and
// |x_i| <= X_i = max(|lo_i|, |hi_i|), eta = 5u (c.w + 2 sum_i X_i |c_i|) +
// 2^-126 (the last term bounds the absolute errors of subnormal results).
#pragma once

#include "common.cuh"

namespace {

constexpr int kNearestTile = 1024;
constexpr int kNearestPix = 8;
constexpr int kNearestThreads = 256;
constexpr int kNearestWarps = kNearestThreads / 32;
// points of one slab of the brick layout: 4 r x 256 g x 256 b codes
constexpr int kBrickSlab = 1 << 18;
// 5 u and 2^-126 (eta above)
constexpr float kDistRel = 5.0f / 16777216.0f;
constexpr float kDistAbs = 1.17549435e-38f;

// the index of point j of lane `lane` in warp `warp` (global warp index)
template <bool kBrick>
__device__ __forceinline__ size_t nearest_point(size_t warp, int lane, int j) {
  if constexpr (kBrick) {
    // slab = 1024 bricks of 4 r x 8 g x 8 b; lanes: 8 b x 4 g, j: 2 g x 4 r
    const size_t slab = warp >> 10;
    const int rem = (int)(warp & 1023);
    const int r = (int)(slab * 4) + (j >> 1);
    const int g = (rem >> 5) * 8 + (lane >> 3) + 4 * (j & 1);
    const int b = (rem & 31) * 8 + (lane & 7);
    return ((size_t)r << 16) | ((size_t)g << 8) | (size_t)b;
  } else {
    return (warp >> 3) * (kNearestThreads * kNearestPix) +
           (warp & 7) * 32 + lane + (size_t)j * kNearestThreads;
  }
}

// max over the box of |x - c|^2, rounded up
__device__ __forceinline__ float box_far(const float* lo, const float* hi,
                                         float4 c) {
  const float cv[3] = {c.x, c.y, c.z};
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float m = fmaxf(__fsub_ru(cv[i], lo[i]), __fsub_ru(hi[i], cv[i]));
    s = __fadd_ru(s, __fmul_ru(m, m));
  }
  return s;
}

// min over the box of |x - c|^2, rounded down
__device__ __forceinline__ float box_near(const float* lo, const float* hi,
                                          float4 c) {
  const float cv[3] = {c.x, c.y, c.z};
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float m = fmaxf(fmaxf(__fsub_rd(lo[i], cv[i]),
                                __fsub_rd(cv[i], hi[i])), 0.0f);
    s = __fadd_rd(s, __fmul_rd(m, m));
  }
  return s;
}

// eta: a bound on pt_dist's rounding error over the box, rounded up
__device__ __forceinline__ float dist_err(const float* xmax, float4 c) {
  float s = __fmul_ru(xmax[0], fabsf(c.x));
  s = __fadd_ru(s, __fmul_ru(xmax[1], fabsf(c.y)));
  s = __fadd_ru(s, __fmul_ru(xmax[2], fabsf(c.z)));
  s = __fadd_ru(c.w, __fmul_ru(2.0f, s));
  return __fadd_ru(__fmul_ru(s, kDistRel), kDistAbs);
}

// counts (kCount only): one int per warp, the centres it scanned
template <typename Label, bool kBrick, bool kCount>
__global__ void __launch_bounds__(kNearestThreads)
    nearest_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ c,
                   const float4* __restrict__ cent,
                   const int* __restrict__ valid, int n, int k,
                   Label* __restrict__ labels, int* __restrict__ counts) {
  __shared__ float4 sc[kNearestTile];
  __shared__ int sv[kNearestTile];
  __shared__ unsigned short slist[kNearestWarps][kNearestTile];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const size_t warp = (size_t)blockIdx.x * kNearestWarps + wib;
  float xa[kNearestPix], xb[kNearestPix], xc[kNearestPix], best[kNearestPix];
  int lbl[kNearestPix];
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  bool any = false;
#pragma unroll
  for (int j = 0; j < kNearestPix; ++j) {
    const size_t q = nearest_point<kBrick>(warp, lane, j);
    const bool in = q < (size_t)n;
    xa[j] = in ? a[q] : 0.0f;
    xb[j] = in ? b[q] : 0.0f;
    xc[j] = in ? c[q] : 0.0f;
    best[j] = INFINITY;
    lbl[j] = 0;
    if (in) {
      any = true;
      lo[0] = fminf(lo[0], xa[j]);
      lo[1] = fminf(lo[1], xb[j]);
      lo[2] = fminf(lo[2], xc[j]);
      hi[0] = fmaxf(hi[0], xa[j]);
      hi[1] = fmaxf(hi[1], xb[j]);
      hi[2] = fmaxf(hi[2], xc[j]);
    }
  }
  any = __any_sync(PT_FULL, any);
  float xmax[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo[i] = fminf(lo[i], __shfl_xor_sync(PT_FULL, lo[i], off));
      hi[i] = fmaxf(hi[i], __shfl_xor_sync(PT_FULL, hi[i], off));
    }
    xmax[i] = fmaxf(fabsf(lo[i]), fabsf(hi[i]));
  }
  float u_best = INFINITY, eta_best = 0.0f;
  int scanned = 0;
  for (int t0 = 0; t0 < k; t0 += kNearestTile) {
    const int cnt = min(kNearestTile, k - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      sc[i] = cent[t0 + i];
      sv[i] = valid[t0 + i];
    }
    __syncthreads();
    if (!any) continue;  // warp-uniform: no point of this warp is in range
    // U over this tile and the tiles before it (each of those centres k
    // was listed there, so it bounds the best distance found so far)
    float ub = u_best, eb = eta_best;
    for (int i = lane; i < cnt; i += 32) {
      if (!sv[i]) continue;
      const float f = box_far(lo, hi, sc[i]);
      if (f < ub) {
        ub = f;
        eb = dist_err(xmax, sc[i]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ou = __shfl_xor_sync(PT_FULL, ub, off);
      const float oe = __shfl_xor_sync(PT_FULL, eb, off);
      if (ou < ub || (ou == ub && oe > eb)) {
        ub = ou;
        eb = oe;
      }
    }
    u_best = ub;
    eta_best = eb;
    unsigned short* list = slist[wib];
    int len = 0;
    for (int s = 0; s < cnt; s += 32) {
      const int i = s + lane;
      bool keep = false;
      if (i < cnt && sv[i]) {
        const float4 cc = sc[i];
        keep = !(__fsub_rd(box_near(lo, hi, cc), u_best) >
                 __fadd_ru(dist_err(xmax, cc), eta_best));
      }
      const unsigned mask = __ballot_sync(PT_FULL, keep);
      if (keep) list[len + __popc(mask & ((1u << lane) - 1u))] = i;
      len += __popc(mask);
    }
    __syncwarp();
    scanned += len;
    for (int m = 0; m < len; ++m) {
      const int i = list[m];
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
    __syncwarp();
  }
#pragma unroll
  for (int j = 0; j < kNearestPix; ++j) {
    const size_t q = nearest_point<kBrick>(warp, lane, j);
    if (q < (size_t)n) labels[q] = (Label)lbl[j];
  }
  if (kCount && lane == 0) counts[warp] = scanned;
}

// cent: (K, 4) rows [c0, c1, c2, |c|^2] (|c|^2 as pt_norm2 sums it);
// valid: (K,) int32; labels: (N,). The brick layout needs N a multiple of
// kBrickSlab.
template <typename Label, bool kBrick, bool kCount = false>
int launch_nearest(const float* a, const float* b, const float* c,
                   const float* cent, const int* valid, int n, int k,
                   Label* labels, int* counts, void* stream) {
  if (kBrick && n % kBrickSlab != 0) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kNearestThreads * kNearestPix;
  const int blocks = (int)((n + per_block - 1) / per_block);
  if (blocks == 0) return 0;
  nearest_kernel<Label, kBrick, kCount>
      <<<blocks, kNearestThreads, 0, (cudaStream_t)stream>>>(
          a, b, c, (const float4*)cent, valid, n, k, labels, counts);
  return (int)cudaGetLastError();
}

}  // namespace
