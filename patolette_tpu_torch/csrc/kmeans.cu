// K4: one weighted Lloyd step.
//
// Replaces the loop body of patolette_tpu/models/kmeans.py::lloyd_iterations
// (assign -> one-hot segment matmul of [w, w x] -> centre update ->
// _split_empty). The JAX package ran it as three XLA programs a step; here
// it is two kernels in two entry points (the moments, then the update, so
// the multi-device route can sum the ranks' moments between them) and no
// host round trip, so a whole single-device KMeans run is enqueued without
// a sync.
//
// kmeans_accumulate (pt_kmeans_moments, one launch): a grid of twice the
// SM count. Each block loads the valid centres of a tile into shared
// memory as a compacted list that keeps their original indices in order
// (no branch on the valid flag in the scan), and each thread holds
// kSamples samples in registers, so every centre's float4 is read once for
// all of them. Nearest centre as K3: |c|^2 - 2 ((xa ca + xb cb) + xc cc)
// with every op rounded on its own (pt_dist), strict <, so the lowest index
// wins ties and carries across tiles. argmin takes the first NaN distance,
// which a strict < skips; a distance can be NaN only where a sample or a
// centre is not pt_tame, so a thread holding such a sample, or a tile
// holding such a valid centre (found as the tile loads), scans with the
// NaN rule (scan_centres<true>); finite inputs never take it. Then [w,
// w x0, w x1, w x2] is added by the warp-grouped accumulation (common.cuh)
// into a (P, 4) table: one a warp where eight fit in the shared-memory
// budget, else fewer, shared by warps that take turns in warp order (P =
// 1024: 4; P >= 2048: 1), else (P > ~9.7k) one in the block's own partial
// in device memory. The block sums its tables in order into its partial,
// and the last blocks to finish sum the partials (pt_finish_partials:
// groups of 16 blocks in block order, then the groups in order) into mom.
// The order of every float sum is fixed: sub-steps in sample order, lanes
// in ascending order, turns in warp order, tables, blocks and groups in
// index order.
// kmeans_finalize (pt_kmeans_update, one launch): ONE block updates the
// centres (mean where the cluster has mass and the slot is valid) and runs
// _split_empty's walk: a valid empty slot takes the valid cluster of
// largest mass (first index on ties), both move by +-1/1024 with
// alternating signs per coordinate, and the mass is halved. A slot's
// emptiness cannot change before the walk reaches it, so the block finds
// the empty slots by ballots and visits only those, in index order (a step
// with none costs no walk); the masses and flags sit in shared memory up
// to P = 32768.
//
// Bound on the H100: f32 operations of the assignment, 7 per (sample,
// centre): at M = 262,144, P = 256, 0.47 GFLOP a step, ~7 us at 67
// TFLOP/s; the bytes (3.1 MB of samples and weights) take ~1 us. The 67
// TFLOP/s count an FMA as two operations and pt_dist may not fuse, so the
// floor of this arithmetic is about twice that, plus the compare and the
// two selects: ~10 issued instructions per (sample, centre). The
// sequential split walk is latency, not throughput: one block-wide argmax
// (warp shuffles, two barriers) for each empty slot.
#include "common.cuh"

namespace {

constexpr float kEps = 1.0f / 1024.0f;
constexpr int kFinalizeThreads = 1024;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSamples = 4;                     // samples a thread holds
constexpr int kBatch = kThreads * kSamples;     // samples a block pass
constexpr int kTile = 2048;                     // centres a shared tile
constexpr int kSharedMasses = 32768;            // largest P of shared masses
constexpr int kSmemPreferred = 100 * 1024;      // two blocks an SM
int g_accumulate_smem[PT_MAX_DEVICES];
int g_finalize_smem[PT_MAX_DEVICES];

// Shared memory of the accumulation other than its tables.
constexpr size_t fixed_smem(int tile) {
  return (size_t)tile * 16 + kWarps * 32 * 4 * 4 + kWarps * 96 * 4 +
         (size_t)tile * 4 + (kWarps + 1) * 4;
}

// The valid centres of [t0, t0 + cnt) in index order: sc[j] = (c, |c|^2),
// sidx[j] = index; returns their number. Warp w compacts its chunk of the
// tile by ballots; the chunks' counts give the offsets.
// odd: some valid centre of the tile is not pt_tame.
__device__ int load_tile(float4* sc, int* sidx, int* wcnt,
                         const float* __restrict__ c,
                         const unsigned char* __restrict__ valid, int t0,
                         int cnt, bool& odd) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int chunk = (cnt + kThreads - 1) / kThreads * 32;
  const int c0 = warp * chunk;
  const int c1 = min(cnt, c0 + chunk);
  int total = 0;
  for (int i = c0; i < c1; i += 32) {
    const bool v = i + lane < c1 && valid[t0 + i + lane];
    total += __popc(__ballot_sync(PT_FULL, v));
  }
  if (lane == 0) wcnt[warp] = total;
  __syncthreads();
  int off = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? wcnt[w] : 0;
    all += wcnt[w];
  }
  bool wild = false;
  for (int i = c0; i < c1; i += 32) {
    const int k = i + lane;
    const bool v = k < c1 && valid[t0 + k];
    const unsigned bal = __ballot_sync(PT_FULL, v);
    if (v) {
      const int pos = off + __popc(bal & ((1u << lane) - 1u));
      const int g = t0 + k;
      const float c0v = c[3 * g], c1v = c[3 * g + 1], c2v = c[3 * g + 2];
      sc[pos] = make_float4(c0v, c1v, c2v, pt_norm2(c0v, c1v, c2v));
      sidx[pos] = g;
      wild |= !pt_tame(c0v, c1v, c2v);
    }
    off += __popc(bal);
  }
  odd = __syncthreads_or(wild);
  return all;
}

// The first nearest of the tile's nv valid centres for this thread's
// samples, carried in (best, lbl) across tiles: strict <, or with kNan
// argmin's rule (a NaN distance is the least, the first NaN wins).
template <bool kNan>
__device__ __forceinline__ void scan_centres(const float4* sc,
                                             const int* sidx, int nv,
                                             const float (&xa)[kSamples],
                                             const float (&xb)[kSamples],
                                             const float (&xc)[kSamples],
                                             float (&best)[kSamples],
                                             int (&lbl)[kSamples]) {
  for (int k = 0; k < nv; ++k) {
    const float4 c = sc[k];
    const int gi = sidx[k];
#pragma unroll
    for (int j = 0; j < kSamples; ++j) {
      const float d = pt_dist(xa[j], xb[j], xc[j], c);
      const bool take =
          kNan ? (d < best[j] || (isnan(d) && !isnan(best[j])))
               : d < best[j];
      if (take) {
        best[j] = d;
        lbl[j] = gi;
      }
    }
  }
}

// The batch at base: this thread's sample j is base + (warp * kSamples +
// j) * 32 + lane (zeros past end).
__device__ __forceinline__ void load_samples(const float* __restrict__ x,
                                             int base, int end, int warp,
                                             int lane, float (&xa)[kSamples],
                                             float (&xb)[kSamples],
                                             float (&xc)[kSamples]) {
#pragma unroll
  for (int j = 0; j < kSamples; ++j) {
    const int q = base + (warp * kSamples + j) * 32 + lane;
    const bool own = q < end;
    xa[j] = own ? x[3 * (size_t)q] : 0.0f;
    xb[j] = own ? x[3 * (size_t)q + 1] : 0.0f;
    xc[j] = own ? x[3 * (size_t)q + 2] : 0.0f;
  }
}

// ntab tables of (P, 4) floats at `tables` (shared memory, or with
// global_table the block's row of the partials).
__global__ void __launch_bounds__(kThreads)
    kmeans_accumulate(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ centers,
                      const unsigned char* __restrict__ valid, int m, int p,
                      int per_block, int ntab, int global_table,
                      float* __restrict__ partials, unsigned* counters,
                      int* __restrict__ labels, float* __restrict__ mom) {
  extern __shared__ float4 smem4[];
  const int tile = min(p, kTile);
  float4* sc = smem4;                                  // tile
  float* stage = (float*)(sc + tile);                  // kWarps * 32 * 4
  int* order = (int*)(stage + kWarps * 32 * 4);        // kWarps * 96
  int* sidx = order + kWarps * 96;                     // tile
  int* wcnt = sidx + tile;                             // kWarps + 1
  float* tables = global_table
                      ? partials + (size_t)blockIdx.x * p * 4
                      : (float*)(wcnt + kWarps + 1);   // ntab * p * 4
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int plen = p * 4;
  float* mystage = stage + warp * 32 * 4;
  float* mytab = tables + (size_t)(warp % ntab) * plen;
  int* myorder = order + warp * 96;

  const int start = blockIdx.x * per_block;
  const int end = min(m, start + per_block);
  float xa[kSamples], xb[kSamples], xc[kSamples];
  // the first batch's samples are loaded before the centres, so the two
  // loads overlap
  load_samples(x, start, end, warp, lane, xa, xb, xc);
  for (int i = threadIdx.x; i < ntab * plen; i += kThreads) tables[i] = 0.0f;
  const bool resident = p <= kTile;
  bool odd_tile = false;
  int nv = resident
               ? load_tile(sc, sidx, wcnt, centers, valid, 0, p, odd_tile)
               : 0;

  for (int base = start; base < end; base += kBatch) {
    if (base != start) load_samples(x, base, end, warp, lane, xa, xb, xc);
    float best[kSamples];
    int lbl[kSamples];
    bool odd = false;
#pragma unroll
    for (int j = 0; j < kSamples; ++j) {
      best[j] = INFINITY;
      lbl[j] = 0;
      odd |= !pt_tame(xa[j], xb[j], xc[j]);
    }
    for (int t0 = 0; t0 < p; t0 += tile) {
      if (!resident) {
        __syncthreads();  // every thread is done with the previous tile
        nv = load_tile(sc, sidx, wcnt, centers, valid, t0,
                       min(tile, p - t0), odd_tile);
      }
      if (odd || odd_tile) {
        scan_centres<true>(sc, sidx, nv, xa, xb, xc, best, lbl);
      } else {
        scan_centres<false>(sc, sidx, nv, xa, xb, xc, best, lbl);
      }
    }
    // the warps sharing a table take turns, in warp order
    for (int turn = 0; turn < kWarps / ntab; ++turn) {
      if (warp / ntab == turn) {
#pragma unroll
        for (int j = 0; j < kSamples; ++j) {
          const int q = base + (warp * kSamples + j) * 32 + lane;
          const bool own = q < end;
          const float wq = own ? (w ? w[q] : 1.0f) : 0.0f;
          if (own && labels) labels[q] = lbl[j];
          *reinterpret_cast<float4*>(mystage + lane * 4) =
              make_float4(wq, __fmul_rn(wq, xa[j]), __fmul_rn(wq, xb[j]),
                          __fmul_rn(wq, xc[j]));
          __syncwarp();
          pt_warp_accumulate(own ? lbl[j] : -1, mystage, 4, mytab,
                             myorder);
          __syncwarp();
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (!global_table) {
    float* dst = partials + (size_t)blockIdx.x * plen;
    for (int i = threadIdx.x; i < plen; i += kThreads) {
      float acc = tables[i];
      for (int t = 1; t < ntab; ++t) {
        acc = __fadd_rn(acc, tables[(size_t)t * plen + i]);
      }
      dst[i] = acc;
    }
  }
  pt_finish_partials(partials, plen, mom, counters);
}

// (v1, i1) <- better of itself and (v2, i2): larger value, then lower index;
// index p marks "no element".
__device__ __forceinline__ void argmax_merge(float& v1, int& i1, float v2,
                                             int i2, int p) {
  if (i2 == p) return;
  if (i1 == p || v2 > v1 || (v2 == v1 && i2 < i1)) {
    v1 = v2;
    i1 = i2;
  }
}

// The split of one valid empty slot ci (_split_empty's loop body): the
// valid cluster of largest mass (lowest index on ties: the merge is exact,
// so any tree gives the same pick) is found by the whole block; both move
// by +-eps, and the mass is halved.
__device__ void split_one(int ci, const unsigned char* sv, float* hs,
                          float* cent, int p, float* red_v, int* red_i) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  float bv = -INFINITY;
  int bi = p;
  for (int k = tid; k < p; k += blockDim.x) {
    argmax_merge(bv, bi, sv[k] ? hs[k] : -INFINITY, k, p);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(PT_FULL, bv, off);
    const int i = __shfl_down_sync(PT_FULL, bi, off);
    argmax_merge(bv, bi, v, i, p);
  }
  if (lane == 0) {
    red_v[tid >> 5] = bv;
    red_i[tid >> 5] = bi;
  }
  __syncthreads();
  if (tid < 32) {
    const int nw = blockDim.x >> 5;
    bv = lane < nw ? red_v[lane] : -INFINITY;
    bi = lane < nw ? red_i[lane] : p;
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(PT_FULL, bv, off);
      const int i = __shfl_down_sync(PT_FULL, bi, off);
      argmax_merge(bv, bi, v, i, p);
    }
  }
  if (tid == 0) {
    const int cj = bi == p ? 0 : bi;
    const float up[3] = {1.0f + kEps, 1.0f - kEps, 1.0f + kEps};
    const float dn[3] = {1.0f - kEps, 1.0f + kEps, 1.0f - kEps};
    float c[3];
    for (int j = 0; j < 3; ++j) c[j] = cent[3 * cj + j];
    for (int j = 0; j < 3; ++j) cent[3 * ci + j] = __fmul_rn(c[j], up[j]);
    for (int j = 0; j < 3; ++j) cent[3 * cj + j] = __fmul_rn(c[j], dn[j]);
    const float half = __fdiv_rn(hs[cj], 2.0f);
    hs[ci] = half;
    hs[cj] = __fadd_rn(hs[cj], -half);
  }
  __syncthreads();
}

// The centres are written to cout directly; the (P,) masses and valid
// flags live in shared memory when they fit (P <= kSharedMasses), else the
// masses in device scratch (ghs) and the flags are read from `valid`.
__global__ void __launch_bounds__(kFinalizeThreads)
    kmeans_finalize(const float* __restrict__ mom,
                    const float* __restrict__ cin, float* cout,
                    const unsigned char* __restrict__ valid, int p,
                    float* ghs) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ unsigned empty[kFinalizeThreads / 32];
  extern __shared__ float fsm[];
  const bool shared = p <= kSharedMasses;
  float* hs = shared ? fsm : ghs;                                    // p
  unsigned char* ssv = (unsigned char*)(fsm + p);                    // p
  const unsigned char* sv = shared ? ssv : valid;

  const int tid = threadIdx.x;
  const float4* mom4 = reinterpret_cast<const float4*>(mom);
  for (int k = tid; k < p; k += blockDim.x) {
    const float4 m = mom4[k];
    const bool v = valid[k];
    float c0 = cin[3 * k], c1 = cin[3 * k + 1], c2 = cin[3 * k + 2];
    if (m.x > 0.0f && v) {
      c0 = __fdiv_rn(m.y, m.x);
      c1 = __fdiv_rn(m.z, m.x);
      c2 = __fdiv_rn(m.w, m.x);
    }
    cout[3 * k] = c0;
    cout[3 * k + 1] = c1;
    cout[3 * k + 2] = c2;
    hs[k] = v ? m.x : 1.0f;
    if (shared) ssv[k] = v;
  }
  __syncthreads();

  // A slot's emptiness does not change before the walk reaches it: a
  // donor's mass h becomes h - h / 2, zero only when h was. So the walk
  // visits the slots that are valid and empty, found kFinalizeThreads at
  // a time by ballots, in index order, and skips the rest.
  for (int c0 = 0; c0 < p; c0 += kFinalizeThreads) {
    const int k = c0 + tid;
    const unsigned bal =
        __ballot_sync(PT_FULL, k < p && sv[k] && hs[k] == 0.0f);
    if ((tid & 31) == 0) empty[tid >> 5] = bal;
    __syncthreads();
    for (int wi = 0; wi < kFinalizeThreads / 32; ++wi) {
      for (unsigned bits = empty[wi]; bits; bits &= bits - 1) {
        split_one(c0 + wi * 32 + __ffs(bits) - 1, sv, hs, cout, p, red_v,
                  red_i);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// The step's first half: labels (optional) and the (P, 4) [w, w x] sums of
// this device's samples into mom. valid: (P,) bytes, 0 or 1. partials:
// (nblocks, P, 4) scratch; counters: nblocks / 16 + 2 ints, zero (and left
// zero). per_block: samples a block, with nblocks * per_block >= m.
PT_EXPORT int pt_kmeans_moments(const float* x, const float* w,
                                 const float* cin, const unsigned char* valid,
                                 int m, int p, int per_block, int nblocks,
                                 float* partials, unsigned* counters,
                                 int* labels, float* mom, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (p < 1 || nblocks < 1 || nblocks > PT_GROUP * PT_MAX_GROUPS) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t fixed = fixed_smem(p < kTile ? p : kTile);
  const size_t table = (size_t)p * 16;
  int ntab = kWarps;
  while (ntab > 1 && fixed + ntab * table > (size_t)kSmemPreferred) ntab /= 2;
  const int global_table = fixed + table > (size_t)PT_SMEM_MAX;
  const size_t smem = fixed + (global_table ? 0 : ntab * table);
  cudaError_t err = pt_opt_in_smem(kmeans_accumulate, PT_SMEM_MAX,
                                   g_accumulate_smem);
  if (err != cudaSuccess) return (int)err;
  kmeans_accumulate<<<nblocks, kThreads, smem, st>>>(
      x, w, cin, valid, m, p, per_block, ntab, global_table, partials,
      counters, labels, mom);
  return (int)cudaGetLastError();
}

// The step's second half: centre update and empty-cluster split from the
// (P, 4) sums mom (this device's, or every rank's), cin -> cout; ghs (P,)
// scratch when P > kSharedMasses.
PT_EXPORT int pt_kmeans_update(const float* mom, const float* cin,
                               const unsigned char* valid, int p, float* cout,
                               float* ghs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = p <= kSharedMasses ? (size_t)p * 5 : 0;
  cudaError_t err = pt_opt_in_smem(kmeans_finalize, PT_SMEM_MAX,
                                   g_finalize_smem);
  if (err != cudaSuccess) return (int)err;
  kmeans_finalize<<<1, kFinalizeThreads, smem, st>>>(mom, cin, cout, valid, p,
                                                     ghs);
  return (int)cudaGetLastError();
}
