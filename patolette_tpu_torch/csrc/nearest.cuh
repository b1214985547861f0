// The nearest-centre scan shared by K3 (labels of image pixels) and K5 (the
// 24-bit table over the ICtCp grid of every uint8 sRGB code): one kernel,
// templated on the label type, so the table and the direct map agree bit
// for bit by construction.
//
// d = |c|^2 - 2 ((xa ca + xb cb) + xc cc) (pt_dist, every op rounded on its
// own); invalid slots are skipped; a slot replaces the best only when
// strictly smaller, so ties go to the lowest index, and a NaN distance
// counts as the least, the first NaN winning, as jnp.argmin and
// torch.argmin have it. A NaN distance needs a non-finite value or centre
// (or a product or |c|^2 past the f32 range); a warp holding such a point
// lists every valid centre, and a warp listing a centre whose eta (below)
// is not finite scans with the NaN rule (nearest_list<, true>); otherwise
// no distance can be NaN and the plain strict < is the same rule.
//
// Design: centres with |c|^2 and the valid flag sit in shared memory, in
// tiles of kNearestTile when K is large; each thread owns kNearestPix
// points and reuses every centre it reads from shared memory kNearestPix
// times. A warp's 256 points are, in the linear layout, 8 runs of 32
// consecutive points 256 apart (on the grid: 8 g x 32 b codes at one r); in
// the brick layout (grids only, n a multiple of 2^18), 4 r x 8 g x 8 b
// codes; in the sorted layout (K3's), 256 consecutive points of its block's
// tile after median splits of its colours (nearest_sorted_kernel).
//
// Pruning. A brute-force scan does 7 rounded f32 operations per
// (point, valid centre), 1.2e11 on the 2^24 grid at K = 1024; so each warp
// first lists the centres that can win anywhere in the box of the values it
// loaded, and scans only those:
//   1. box: the min and max of a, b and c over the warp's in-range points
//      (warp reductions; NaN coordinates drop out);
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
// the centre, so an infinite coordinate gives the full scan; a centre that
// can give a NaN or infinite distance at a finite point has an eta that is
// not finite, so it is always listed.
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

// The scan over one tile's list: the first minimum in list order, a NaN
// distance counting as the least when kNan (argmin's rule; needed only
// where a value or a centre is not finite, see nearest_scan).
template <int P, bool kNan>
__device__ __forceinline__ void nearest_list(const float* xa, const float* xb,
                                             const float* xc, float* best,
                                             int* lbl, const float4* sc,
                                             const unsigned short* list,
                                             int len, int t0) {
  for (int m = 0; m < len; ++m) {
    const int i = list[m];
    const float4 cc = sc[i];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float d = pt_dist(xa[j], xb[j], xc[j], cc);
      const bool take = kNan ? (d < best[j] || (isnan(d) && !isnan(best[j])))
                             : d < best[j];
      if (take) {
        best[j] = d;
        lbl[j] = t0 + i;
      }
    }
  }
}

// The scan of one warp's points (xa, xb, xc[j], in[j]: in range) into
// lbl[j]. Every thread of the block calls it: the centre tiles are loaded
// by the whole block into sc / sv; list is this warp's kNearestTile
// entries. Returns the centres this warp listed, summed over the tiles.
template <int P>
__device__ __forceinline__ int nearest_scan(
    const float* xa, const float* xb, const float* xc, const bool* in,
    int* lbl, float4* sc, int* sv, unsigned short* list,
    const float4* __restrict__ cent, const int* __restrict__ valid, int k) {
  const int lane = threadIdx.x & 31;
  float best[P];
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  bool any = false, odd = false;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    best[j] = INFINITY;
    lbl[j] = 0;
    if (in[j]) {
      any = true;
      odd |= !(isfinite(xa[j]) && isfinite(xb[j]) && isfinite(xc[j]));
      lo[0] = fminf(lo[0], xa[j]);
      lo[1] = fminf(lo[1], xb[j]);
      lo[2] = fminf(lo[2], xc[j]);
      hi[0] = fmaxf(hi[0], xa[j]);
      hi[1] = fmaxf(hi[1], xb[j]);
      hi[2] = fmaxf(hi[2], xc[j]);
    }
  }
  any = __any_sync(PT_FULL, any);
  odd = __any_sync(PT_FULL, odd);
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
    int len = 0;
    bool wide = false;  // this lane listed a centre whose eta is not finite
    for (int s = 0; s < cnt; s += 32) {
      const int i = s + lane;
      bool keep = false;
      if (i < cnt && sv[i]) {
        const float4 cc = sc[i];
        const float eta = dist_err(xmax, cc);
        keep = odd || !(__fsub_rd(box_near(lo, hi, cc), u_best) >
                        __fadd_ru(eta, eta_best));
        wide |= keep && !isfinite(eta);
      }
      const unsigned mask = __ballot_sync(PT_FULL, keep);
      if (keep) list[len + __popc(mask & ((1u << lane) - 1u))] = i;
      len += __popc(mask);
    }
    const bool nan_scan = odd || __any_sync(PT_FULL, wide);
    __syncwarp();
    scanned += len;
    if (nan_scan) {
      nearest_list<P, true>(xa, xb, xc, best, lbl, sc, list, len, t0);
    } else {
      nearest_list<P, false>(xa, xb, xc, best, lbl, sc, list, len, t0);
    }
    __syncwarp();
  }
  return scanned;
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
  float xa[kNearestPix], xb[kNearestPix], xc[kNearestPix];
  bool in[kNearestPix];
  int lbl[kNearestPix];
#pragma unroll
  for (int j = 0; j < kNearestPix; ++j) {
    const size_t q = nearest_point<kBrick>(warp, lane, j);
    in[j] = q < (size_t)n;
    xa[j] = in[j] ? a[q] : 0.0f;
    xb[j] = in[j] ? b[q] : 0.0f;
    xc[j] = in[j] ? c[q] : 0.0f;
  }
  const int scanned = nearest_scan<kNearestPix>(
      xa, xb, xc, in, lbl, sc, sv, slist[wib], cent, valid, k);
#pragma unroll
  for (int j = 0; j < kNearestPix; ++j) {
    const size_t q = nearest_point<kBrick>(warp, lane, j);
    if (in[j]) labels[q] = (Label)lbl[j];
  }
  if (kCount && lane == 0) counts[warp] = scanned;
}

// The sorted layout (K3's): a block of kThreads threads takes a tile of
// kThreads * kNearestPix consecutive points and cuts it, in shared memory,
// into boxes of 32 * kNearestPix points by median splits (a k-d tree), one
// box a warp, each scanned with nearest_scan as the other layouts are. A
// level splits every node in two at the median of its widest channel: the
// node's box (min and max of its points; NaN drops out), the channel of the
// largest extent (the first on ties), each point's bin of kKdBins levels of
// that channel across the node's own range (below 1, NaN among them, to 0;
// saturating at the top), a histogram of (node, bin) in shared memory
// (integer atomics), its exclusive scan (whose starts are the nodes' own
// since every node holds its exact share of the tile) and a scatter by
// atomic tickets; the node's first half of the new order is one child, the
// second half the other. Points past the tile's end are carried along as
// NaN and scanned by nobody. Each label goes back to its point's own index
// through a staging copy in shared memory, stored coalesced. Nothing of size
// N is written but the labels.
// Median splits and not a sort by a colour key: consecutive runs of a Morton
// order straddle its jumps, and in each block of 32 runs one such box held
// nearly every centre (243 of 253 on the synthetic 4K image at the block's
// worst warp, against 101 for median splits; kernels/assign.py's model),
// and a block waits for its slowest warp.
//
// Why the labels cannot change: a point's label is the first minimum (the
// first NaN, if any) over the centres its warp listed, and the list holds
// every centre that can win or tie anywhere in the warp's box (the argument
// at the top of this file), or every valid centre when the warp holds a
// non-finite value. That holds for any grouping of the points into warps, so
// the grouping decides which centres are listed, never a label. No float is
// accumulated across points, so an order of ties that depends on scheduling
// changes no bit either.
constexpr int kKdBins = 256;

template <int kThreads>
struct SortedSmem {
  static constexpr int kTilePts = kThreads * kNearestPix;
  static constexpr int kWarps = kThreads / 32;
  // median-split levels down to one box a warp
  static constexpr int kLevels = kWarps == 32 ? 5 : kWarps == 16 ? 4 : 3;
  static_assert((1 << kLevels) == kWarps, "a box a warp");
  static constexpr int kHistLen = (kWarps / 2) * kKdBins;
  static_assert(kHistLen % kThreads == 0, "the scan's runs");
  // phase 1: the tile's planes in slot order [kPlanes, 12 T)
  static constexpr size_t kPlanes = 0;
  // phase 2: the centre tile and flags, the warps' lists
  static constexpr size_t kCent = 0;
  static constexpr size_t kValid = kCent + 16 * (size_t)kNearestTile;
  static constexpr size_t kLists = kValid + 4 * (size_t)kNearestTile;
  static constexpr size_t kEnd2 = kLists + 2 * (size_t)kNearestTile * kWarps;
  // both phases: the two orders of the tile's slots
  static constexpr size_t kPerm =
      ((12 * (size_t)kTilePts > kEnd2 ? 12 * (size_t)kTilePts : kEnd2) + 15) /
      16 * 16;
  // phase 1: the histogram, the warps' and the nodes' boxes; phase 2: the
  // labels
  static constexpr size_t kHist = kPerm + 4 * (size_t)kTilePts;
  static constexpr size_t kWbox = kHist + 4 * (size_t)kHistLen;
  static constexpr size_t kNbox = kWbox + 4 * 8 * (size_t)kWarps;
  static constexpr size_t kLabels = kHist;
  static constexpr size_t kEnd1 = kNbox + 4 * 8 * (size_t)(kWarps / 2);
  static constexpr size_t kEndL = kLabels + 4 * (size_t)kTilePts;
  static constexpr size_t kBytes = kEnd1 > kEndL ? kEnd1 : kEndL;
};

__device__ __forceinline__ int kd_bin(float x, float lo, float scale) {
  const float v = __fmul_rn(__fsub_rn(x, lo), scale);
  return v >= 1.0f ? min((int)v, kKdBins - 1) : 0;
}

template <int kThreads, bool kCount>
__global__ void __launch_bounds__(kThreads, kThreads <= 512 ? 2 : 1)
    nearest_sorted_kernel(const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ c,
                          const float4* __restrict__ cent,
                          const int* __restrict__ valid, int n, int k,
                          int* __restrict__ labels, int* __restrict__ counts) {
  using L = SortedSmem<kThreads>;
  constexpr int kP = kNearestPix;
  constexpr int kT = L::kTilePts;
  constexpr int kW = L::kWarps;
  extern __shared__ float4 pool4[];
  unsigned char* pool = reinterpret_cast<unsigned char*>(pool4);
  float* planes = reinterpret_cast<float*>(pool + L::kPlanes);  // 3 x kT
  unsigned short* perm =
      reinterpret_cast<unsigned short*>(pool + L::kPerm);  // 2 x kT
  int* hist = reinterpret_cast<int*>(pool + L::kHist);
  float* wbox = reinterpret_cast<float*>(pool + L::kWbox);
  float* nbox = reinterpret_cast<float*>(pool + L::kNbox);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wib = tid >> 5;
  const size_t base = (size_t)blockIdx.x * kT;
  const int cnt = (int)min((long long)kT, (long long)n - (long long)base);

  // the tile in slot order (coalesced); slots past its end as NaN
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int i = tid + kThreads * j;
    const bool ok = i < cnt;
    planes[i] = ok ? a[base + i] : NAN;
    planes[kT + i] = ok ? b[base + i] : NAN;
    planes[2 * kT + i] = ok ? c[base + i] : NAN;
    perm[i] = (unsigned short)i;
  }
  // median splits: thread t holds positions [t kP, t kP + kP) of each level's
  // order, all in one node (a node spans at least two warps)
  int src = 0;
#pragma unroll 1
  for (int level = 0; level < L::kLevels; ++level) {
    const int size = kT >> level;
    const int node = tid * kP / size;
    const unsigned short* from = perm + src * kT;
    unsigned short* to = perm + (1 - src) * kT;
    __syncthreads();
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    int slot[kP];
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      slot[q] = from[tid * kP + q];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float v = planes[ch * kT + slot[q]];
        lo[ch] = fminf(lo[ch], v);
        hi[ch] = fmaxf(hi[ch], v);
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo[ch] = fminf(lo[ch], __shfl_xor_sync(PT_FULL, lo[ch], off));
        hi[ch] = fmaxf(hi[ch], __shfl_xor_sync(PT_FULL, hi[ch], off));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        wbox[wib * 8 + ch] = lo[ch];
        wbox[wib * 8 + 3 + ch] = hi[ch];
      }
    }
    for (int i = tid; i < L::kHistLen; i += kThreads) hist[i] = 0;
    __syncthreads();
    const int nodes = 1 << level;
    const int wpn = kW >> level;  // warps a node
    if (tid < nodes * 6) {
      const int nd = tid / 6, comp = tid % 6;
      float r = wbox[nd * wpn * 8 + comp];
      for (int w = 1; w < wpn; ++w) {
        const float o = wbox[(nd * wpn + w) * 8 + comp];
        r = comp < 3 ? fminf(r, o) : fmaxf(r, o);
      }
      nbox[nd * 8 + comp] = r;
    }
    __syncthreads();
    // the node's widest channel, the first on ties (NaN never wider)
    int axis = 0;
    float ext = __fsub_rn(nbox[node * 8 + 3], nbox[node * 8]);
#pragma unroll
    for (int ch = 1; ch < 3; ++ch) {
      const float e = __fsub_rn(nbox[node * 8 + 3 + ch], nbox[node * 8 + ch]);
      if (e > ext) {
        ext = e;
        axis = ch;
      }
    }
    const float lo_a = nbox[node * 8 + axis];
    const float scale = __fdiv_rn((float)kKdBins, ext);
    int key[kP];
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      key[q] = node * kKdBins +
               kd_bin(planes[axis * kT + slot[q]], lo_a, scale);
      atomicAdd(&hist[key[q]], 1);
    }
    __syncthreads();
    {
      // exclusive scan of the histogram, node-major: each node's bins start
      // at its own first position
      constexpr int kRun = L::kHistLen / kThreads;
      int run[kRun];
      int total = 0;
#pragma unroll
      for (int m = 0; m < kRun; ++m) {
        run[m] = hist[tid * kRun + m];
        total += run[m];
      }
      int incl = total;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(PT_FULL, incl, off);
        if (lane >= off) incl += o;
      }
      int* wsum = reinterpret_cast<int*>(wbox);  // the boxes are read
      if (lane == 31) wsum[wib] = incl;
      __syncthreads();
      int offset = incl - total;
      for (int w = 0; w < wib; ++w) offset += wsum[w];
#pragma unroll
      for (int m = 0; m < kRun; ++m) {
        hist[tid * kRun + m] = offset;
        offset += run[m];
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      to[atomicAdd(&hist[key[q]], 1)] = (unsigned short)slot[q];
    }
    src = 1 - src;
  }
  __syncthreads();
  // this warp's box: positions [wib 32 kP, (wib + 1) 32 kP) of the last order
  const unsigned short* fin = perm + src * kT;
  float xa[kP], xb[kP], xc[kP];
  bool in[kP];
  int lbl[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int s = fin[wib * (32 * kP) + j * 32 + lane];
    in[j] = s < cnt;
    xa[j] = in[j] ? planes[s] : 0.0f;
    xb[j] = in[j] ? planes[kT + s] : 0.0f;
    xc[j] = in[j] ? planes[2 * kT + s] : 0.0f;
  }
  // phase 2 reuses the planes' space (nearest_scan starts with a barrier)
  const int scanned = nearest_scan<kP>(
      xa, xb, xc, in, lbl, reinterpret_cast<float4*>(pool + L::kCent),
      reinterpret_cast<int*>(pool + L::kValid),
      reinterpret_cast<unsigned short*>(pool + L::kLists) +
          wib * kNearestTile,
      cent, valid, k);
  int* slab = reinterpret_cast<int*>(pool + L::kLabels);
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    if (in[j]) slab[fin[wib * (32 * kP) + j * 32 + lane]] = lbl[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int i = tid + kThreads * j;
    if (i < cnt) labels[base + i] = slab[i];
  }
  if (kCount && lane == 0) counts[(size_t)blockIdx.x * kW + wib] = scanned;
}

// Block size of K3's sorted layout: tiles of 8192 points, 32 boxes a
// block (chip_smoke.py's sweep against tiles of 4096).
constexpr int kSortThreads = 1024;

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

// The sorted layout with kThreads threads a block; counts: one int per
// warp (kCount).
template <int kThreads, bool kCount = false>
int launch_nearest_sorted(const float* a, const float* b, const float* c,
                          const float* cent, const int* valid, int n, int k,
                          int* labels, int* counts, void* stream) {
  static int done[PT_MAX_DEVICES] = {};
  using L = SortedSmem<kThreads>;
  const int blocks = (int)((n + (long long)L::kTilePts - 1) / L::kTilePts);
  if (blocks == 0) return 0;
  cudaError_t err = pt_opt_in_smem(nearest_sorted_kernel<kThreads, kCount>,
                                   (int)L::kBytes, done);
  if (err != cudaSuccess) return (int)err;
  nearest_sorted_kernel<kThreads, kCount>
      <<<blocks, kThreads, L::kBytes, (cudaStream_t)stream>>>(
          a, b, c, (const float4*)cent, valid, n, k, labels, counts);
  return (int)cudaGetLastError();
}

}  // namespace
