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
// permutation (a lane reads its pixels through the permutation itself), the
// one-hot matmul colour selection (the palette is indexed) and the unroll.
//
// Design: a lane is a group of G threads (4, 8, 16 or 32; several lanes a
// warp; the wrapper picks G by K). Thread r of a group keeps the queue sums
// of channel r % 3 and the palette entries r, r + G, r + 2G, ... as its
// share of the argmin: in registers (pa, pb, pc, ps2; at most 32 entries a
// thread, padded with (0, 0, 0, +inf), which never win), or in shared memory
// above that, walked in tiles above kTile entries with the block in step.
// A step:
//   1. q = (px + S) * cw for the thread's channel, S the step's queue sum;
//      the group's threads 0, 1 and 2 hand q0, q1 and q2 to the group
//      (shuffles);
//   2. the argmin: each thread's entries in four independent minimum chains,
//      merged by (distance, index) as a tree, then log2(G) xor-shuffle levels
//      inside the group carrying the index (ties to the lower index);
//   3. the error of the thread's channel, px - raw[idx] (raw colours in
//      shared memory, channel-planar), and the queue sums: the sum of step t,
//      ((0 + w0 e_{t-16}) + w1 e_{t-15}) ... + w15 e_{t-1}, is built as each
//      error arrives, every pending sum taking its term at once (the
//      accumulators below), so only w15 e_s and one addition wait for the
//      argmin.
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn) in the
// plain version's order, so the labels equal the plain version's.
// NaN: argmin takes the first NaN distance, which the chains' strict < and
// fminf skip. A distance can be NaN (or -inf) only where the query or an
// entry is not pt_tame. The entries and raw colours are tested once as the
// block starts, and each step's pixel (small3) with no branch: with all of
// them small, no query is wild. Where one is not, the block's lanes (each
// a chain from a zero queue) run again from their start in a second copy
// that tests each query, and where that fails anywhere in the warp the
// groups concerned scan again with argmin's rule (scan_nan: the real
// entries from device memory, then a NaN-ordered merge). Finite inputs
// never take that path (dither_kernel below).
// Pixels come in batches of 16 steps: while a batch runs, cp.async copies the
// next batch's three channel values (through permutation entries copied one
// batch earlier) into the lane's other stage buffer in shared memory, so no
// step waits for device memory. Steps past a lane's end read a zero pixel and
// write nothing (a warp runs to its longest lane's last batch).
// Every shuffle and warp barrier names the whole warp: with a group's mask
// the compiler guards each shuffle with a convergence check costing more
// than the shuffle. The step loop is not unrolled: unrolled 16 times around
// 32 register entries the code outgrew the instruction cache and ran 1.6x
// slower (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's K8 sweep).
// The palette in shared memory as float4 (pa, pb, pc, ps2) an entry: a
// quarter-warp phase reads 128 consecutive bytes, so no bank conflicts, but
// every lane then reads the whole palette from shared memory every step,
// 16 B an entry: at 4K and 256 entries 34 GB, ~1 ms of the H100's shared
// memory bandwidth, which the register palette does not pay.
//
// Bound on the H100: the larger of the operations, 7 f32 per (pixel, valid
// entry) plus the queue (at 4K, K = 256, 14.9 GFLOP, ~0.22 ms at 67
// TFLOP/s), and the chain: `seg` dependent steps a lane (4096 at the
// default), each at least the latency of step 1's products and shuffle, one
// distance, the minimum of a thread's entries as a tree, log2(G) shuffle
// levels, the raw colour's shared-memory load and step 3's product and two
// sums (chip_smoke.py's k8_chain_cycles: 219 cycles at G = 8, K = 256, 0.45
// ms at 1.98 GHz).
#include "common.cuh"

namespace {

constexpr int kQueue = 16;
constexpr int kSteps = 16;        // steps a batch of staged pixels
constexpr int kChains = 4;        // independent minimum chains a thread
static_assert(kChains == 4, "scan_tile merges four chains as a tree");
constexpr int kTile = 2048;       // palette entries resident in shared memory
// a lane's two stage buffers (x0, x1, x2, pixel a step) and two batches of
// permutation entries
constexpr int kStageBytes = 2 * kSteps * 16 + 2 * kSteps * 4;

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// cp.async: a 4-byte copy from device to shared memory that completes in
// the background (the issuing thread's copies are done after
// cp_async_wait_all).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Entries [t0, t0 + cnt) of the table into spal (padded with (0, 0, 0,
// +inf) up to pad); with raw, their raw colours channel-planar (stride pad).
__device__ __forceinline__ void load_palette(float4* spal, float* raw,
                                             const float4* __restrict__ table,
                                             int t0, int cnt, int pad) {
  for (int e = threadIdx.x; e < pad; e += blockDim.x) {
    if (e < cnt) {
      if (spal != nullptr) spal[e] = table[2 * (size_t)(t0 + e)];
      if (raw != nullptr) {
        const float4 c = table[2 * (size_t)(t0 + e) + 1];
        raw[e] = c.x;
        raw[pad + e] = c.y;
        raw[2 * pad + e] = c.z;
      }
    } else if (spal != nullptr) {
      spal[e] = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
    }
  }
}

// (value, index) pairs: (ov, oi) replaces (v, i) when smaller, or equal at
// a lower index. Bitwise, not short-circuit, so that no branch splits the
// step's code into blocks the scheduler cannot interleave.
__device__ __forceinline__ void take_min(float& v, int& i, float ov, int oi) {
  const bool t = (ov < v) | ((ov == v) & (oi < i));
  v = t ? ov : v;
  i = t ? oi : i;
}

// The first minimum of this thread's entries r, r + G, ... of the tile in
// spal (pad entries, a multiple of G * kChains), merged into (best, bi)
// (the tiles before it hold lower indices, so only a smaller value wins).
template <int G>
__device__ __forceinline__ void scan_tile(const float4* spal, int pad, int r,
                                          int t0, float q0, float q1, float q2,
                                          float& best, int& bi) {
  float v[kChains];
  int at[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    v[c] = INFINITY;
    at[c] = -1;
  }
  const int per = pad / G;
  // the next iteration's entries are loaded while this one's are scanned
  // (the last iteration reloads its own: no read past the tile)
  float4 e[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) e[c] = spal[r + G * c];
#pragma unroll 1
  for (int i = 0; i < per; i += kChains) {
    const int nx = min(i + kChains, per - kChains);
    float4 f[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) f[c] = spal[r + G * (nx + c)];
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      const float d = pt_dist(q0, q1, q2, e[c]);
      at[c] = d < v[c] ? i : at[c];
      v[c] = fminf(v[c], d);  // NaN never enters; +-0 compare equal
      e[c] = f[c];
    }
  }
  // a chain that took nothing holds +inf and cannot pass the strict test
  // below whatever index it names
  int idx[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) idx[c] = t0 + r + G * (at[c] + c);
  // chains (0, 1) and (2, 3), then the pair
  take_min(v[0], idx[0], v[1], idx[1]);
  take_min(v[2], idx[2], v[3], idx[3]);
  take_min(v[0], idx[0], v[2], idx[2]);
  const float tv = v[0];
  const int ti = idx[0];
  const bool t = tv < best;
  best = t ? tv : best;
  bi = t ? ti : bi;
}

// The same first minimum over this thread's kPer entries held in
// registers (pal[i] = entry r + G i; padding entries (0, 0, 0, +inf)).
template <int G, int kPer>
__device__ __forceinline__ void scan_regs(const float4 (&pal)[kPer], int r,
                                          float q0, float q1, float q2,
                                          float& best, int& bi) {
  float v[kChains];
  int at[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    v[c] = INFINITY;
    at[c] = -1;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = i % kChains;
    const float d = pt_dist(q0, q1, q2, pal[i]);
    at[c] = d < v[c] ? i : at[c];
    v[c] = fminf(v[c], d);
  }
  int idx[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) idx[c] = r + G * at[c];
  take_min(v[0], idx[0], v[1], idx[1]);
  take_min(v[2], idx[2], v[3], idx[3]);
  take_min(v[0], idx[0], v[2], idx[2]);
  const bool t = v[0] < best;
  best = t ? v[0] : best;
  bi = t ? idx[0] : bi;
}

// |v| <= 2^50 for each (so not NaN or infinite). With every pixel of a
// lane and every raw colour this small, an error is at most 2^51,
// a queue sum (weights summing to < 8) under 2^54 and the query under
// 2^55: pt_tame, so against tame entries no distance is NaN.
__device__ __forceinline__ bool small3(float a, float b, float c) {
  constexpr float kSmall = 1.125899906842624e15f;  // 2^50
  return fabsf(a) <= kSmall && fabsf(b) <= kSmall && fabsf(c) <= kSmall;
}

// Argmin's first minimum, a NaN distance the least, over this thread's
// real entries r, r + G, ... (< k) read from the table in device memory:
// the path of queries or palettes that are not pt_tame (at most k / G
// loads a step, on no finite input's path).
template <int G>
__device__ __noinline__ void scan_nan(const float4* __restrict__ table,
                                      int k, int r, float q0, float q1,
                                      float q2, float& best, int& bi) {
  best = INFINITY;
  bi = k;  // "none"
  for (int e = r; e < k; e += G) {
    const float d = pt_dist(q0, q1, q2, table[2 * (size_t)e]);
    if (d < best || (isnan(d) && !isnan(best))) {
      best = d;
      bi = e;
    }
  }
}

// kPer: the palette's place. -1: walked in tiles of kTile entries; 0:
// resident in shared memory; > 0: kPer entries a thread in registers.
// The lanes of this block (kCheck: each query tested for the NaN rule);
// returns whether a pixel channel this thread took was not small3 (without
// kCheck).
template <int G, int kPer, bool kCheck>
__device__ __forceinline__ bool dither_lanes(
    const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ x2, const int* __restrict__ perm,
    const float4* __restrict__ table, const float* __restrict__ params,
    int n, int k, int seg, int lanes, int* __restrict__ out,
    bool wild_palette) {
  extern __shared__ float4 smem[];
  constexpr bool kResident = kPer >= 0;
  constexpr bool kRegs = kPer > 0;
  constexpr int kLoad = (kSteps + G - 1) / G;  // stage items a thread fills
  const int lanes_in_block = blockDim.x / G;
  const int pad =
      kRegs ? G * kPer : (kResident ? round_up(k, G * kChains) : kTile);
  // shared memory: [the palette (not kRegs)] [raw colours (resident)]
  // [stage buffers]
  float4* spal = smem;
  float* sraw = reinterpret_cast<float*>(kRegs ? smem : smem + pad);
  float4* stage_all =
      kResident ? reinterpret_cast<float4*>(sraw + 3 * pad) : smem + kTile;

  const int r = threadIdx.x % G;
  const int lib = threadIdx.x / G;
  const int lane = blockIdx.x * lanes_in_block + lib;
  const int gbase = (threadIdx.x & 31) & ~(G - 1);
  const int ch = r % 3;
  const long long start = (long long)lane * seg;
  const int len = lane < lanes ? (int)min((long long)seg, n - start) : 0;
  // this lane's stage buffers: st[2][kSteps] (x0, x1, x2, pixel), then
  // pq[2][kSteps] (permutation entries)
  float4* st = stage_all + lib * (kStageBytes / 16);
  const float* st_f = reinterpret_cast<const float*>(st);
  int* pq = reinterpret_cast<int*>(st + 2 * kSteps);

  if (kResident) {
    load_palette(kRegs ? nullptr : spal, sraw, table, 0, k, pad);
    __syncthreads();
  }
  float4 pal[kRegs ? kPer : 1];
#pragma unroll
  for (int i = 0; i < (kRegs ? kPer : 0); ++i) {
    const int e = r + G * i;
    pal[i] = e < k ? table[2 * (size_t)e]
                   : make_float4(0.0f, 0.0f, 0.0f, INFINITY);
  }
  // Every shuffle and warp barrier below names the whole warp, so the warp
  // runs as many batches as its longest lane: with the palette resident a
  // lane stops at its end, rounded up to a batch, and the warp at its
  // longest lane's; otherwise every lane runs all `seg` steps so that the
  // block stays in step for the tiled walk.
  const int batches =
      kResident ? __reduce_max_sync(PT_FULL, (len + kSteps - 1) / kSteps)
                : (seg + kSteps - 1) / kSteps;
  if (batches == 0) return false;  // warp-uniform; no barrier follows

  float qw[kQueue];
#pragma unroll
  for (int q = 0; q < kQueue; ++q) qw[q] = params[q];
  const float cw = params[kQueue + ch];
  // The queue sum of step t, ((0 + w0 e_{t-16}) + w1 e_{t-15}) ... + w15
  // e_{t-1}, is built as each error arrives: when step s has e_s, every
  // pending sum takes its term at once: acc[q] (the sum of step s + 2 + q,
  // weight w_{14-q}) moves to acc[q - 1] as it takes it, acc[13] starts the
  // sum of step s + 16 as 0 + w0 e_s, part (step s + 1 before its last
  // term) takes w14 e_s from acc[0] and sum w15 e_s from part. So each sum
  // keeps the plain version's operations and order, no sum is a chain within
  // a step, no register is moved (the shift is the sums' destinations), and
  // only w15 e_s and one addition wait for the argmin.
  float acc[kQueue - 2];
#pragma unroll
  for (int q = 0; q < kQueue - 2; ++q) acc[q] = 0.0f;
  float part = 0.0f;  // the sum of step s + 1 before w15 e_s
  float sum = 0.0f;   // the sum of this step

  // The lane's pixels move in batches of kSteps steps; thread r stages the
  // steps r, r + G, ... of a batch. While batch b runs, cp.async copies
  // batch b + 1's channel values (through the permutation entries already in
  // pq) into the other stage buffer and batch b + 2's permutation entries into
  // pq, so no step waits for device memory. A slot past the lane's end holds
  // a zero pixel and pixel -1 (no label is written).
  {
#pragma unroll
    for (int m = 0; m < kLoad; ++m) {
      const int slot = r + G * m;
      if (slot < kSteps) {
        const int pix = slot < len ? perm[start + slot] : -1;
        st[slot] = pix >= 0 ? make_float4(x0[pix], x1[pix], x2[pix],
                                          __int_as_float(pix))
                            : make_float4(0.0f, 0.0f, 0.0f, __int_as_float(-1));
        const int i1 = kSteps + slot;
        pq[kSteps + slot] = i1 < len ? perm[start + i1] : -1;
      }
    }
    __syncwarp();
  }
  bool wild_seen = false;  // a pixel of the lane that is not small3
  // One batch: the copies of the next batch's pixels, this batch's steps
  // (kCheck: each query tested for the NaN rule), the wait for the copies.
  auto batch = [&](int b) {
    const float4* cur = st + (b & 1) * kSteps;
    const float* cur_f = st_f + (b & 1) * kSteps * 4;
#pragma unroll
    for (int m = 0; m < kLoad; ++m) {
      const int slot = r + G * m;
      if (slot < kSteps) {
        float4* d = st + ((b + 1) & 1) * kSteps + slot;
        const int pix = pq[((b + 1) & 1) * kSteps + slot];
        if (pix >= 0) {
          cp_async4(&d->x, x0 + pix);
          cp_async4(&d->y, x1 + pix);
          cp_async4(&d->z, x2 + pix);
        } else {
          d->x = d->y = d->z = 0.0f;
        }
        d->w = __int_as_float(pix);
        const int i2 = (b + 2) * kSteps + slot;
        int* p2 = pq + (b & 1) * kSteps + slot;
        if (i2 < len) {
          cp_async4(p2, perm + start + i2);
        } else {
          *p2 = -1;
        }
      }
    }
    cp_async_commit();
    {
      float px = cur_f[ch];
#pragma unroll 1
      for (int j = 0; j < kSteps; ++j) {
        const float px_next = cur_f[4 * ((j + 1) % kSteps) + ch];
        const float qc = __fmul_rn(__fadd_rn(px, sum), cw);
        // this thread's channel of the step's pixel (the group's threads
        // 0, 1 and 2 hold the three); no branch
        if constexpr (!kCheck) wild_seen |= !small3(px, px, px);
        const float q0 = __shfl_sync(PT_FULL, qc, gbase);
        const float q1 = __shfl_sync(PT_FULL, qc, gbase + 1);
        const float q2 = __shfl_sync(PT_FULL, qc, gbase + 2);
        float best = INFINITY;
        int bi = k;  // "none"
        if constexpr (kRegs) {
          scan_regs<G, kPer>(pal, r, q0, q1, q2, best, bi);
        } else if constexpr (kResident) {
          scan_tile<G>(spal, pad, r, 0, q0, q1, q2, best, bi);
        } else {
          for (int t0 = 0; t0 < k; t0 += kTile) {
            const int cnt = min(kTile, k - t0);
            const int tpad = round_up(cnt, G * kChains);
            __syncthreads();
            load_palette(spal, nullptr, table, t0, cnt, tpad);
            __syncthreads();
            scan_tile<G>(spal, tpad, r, t0, q0, q1, q2, best, bi);
          }
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(PT_FULL, best, off);
          const int oi = __shfl_xor_sync(PT_FULL, bi, off);
          take_min(best, bi, ob, oi);
        }
        if constexpr (kCheck) {
          // q is the group's, so a group agrees on wild_q; the vote is the
          // warp's (every shuffle names the whole warp)
          const bool wild_q = wild_palette || !pt_tame(q0, q1, q2);
          if (__any_sync(PT_FULL, wild_q)) {
            float nb;
            int ni;
            scan_nan<G>(table, wild_q ? k : 0, r, q0, q1, q2, nb, ni);
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1) {
              const float ob = __shfl_xor_sync(PT_FULL, nb, off);
              const int oi = __shfl_xor_sync(PT_FULL, ni, off);
              pt_take_min_nan(nb, ni, ob, oi);
            }
            if (wild_q) {
              best = nb;
              bi = ni;
            }
          }
        }
        if (bi >= k) bi = 0;  // every distance +inf: argmin's first index
        const float raw =
            kResident ? sraw[ch * pad + bi]
                      : reinterpret_cast<const float*>(table)[8 * (size_t)bi +
                                                              4 + ch];
        const float e = __fsub_rn(px, raw);
        sum = __fadd_rn(part, __fmul_rn(qw[kQueue - 1], e));
        part = __fadd_rn(acc[0], __fmul_rn(qw[kQueue - 2], e));
#pragma unroll
        for (int q = 1; q < kQueue - 2; ++q) {
          acc[q - 1] = __fadd_rn(acc[q], __fmul_rn(qw[kQueue - 2 - q], e));
        }
        acc[kQueue - 3] = __fadd_rn(0.0f, __fmul_rn(qw[0], e));
        const int pix = __float_as_int(cur[j].w);
        if (r == j % G && pix >= 0) out[pix] = bi;
        px = px_next;
      }
    }
    cp_async_wait_all();
    __syncwarp();
  };

  for (int b = 0; b < batches; ++b) batch(b);
  return wild_seen;
}

template <int G, int kPer>
__device__ __noinline__ void dither_lanes_checked(
    const float* __restrict__ x0, const float* __restrict__ x1,
    const float* __restrict__ x2, const int* __restrict__ perm,
    const float4* __restrict__ table, const float* __restrict__ params,
    int n, int k, int seg, int lanes, int* __restrict__ out,
    bool wild_palette) {
  dither_lanes<G, kPer, true>(x0, x1, x2, perm, table, params, n, k, seg,
                              lanes, out, wild_palette);
}

// A lane is a chain that starts from a zero queue, so it can be run again
// from its start. The block's lanes run without the NaN rule's test,
// noting whether any pixel was not small3 (one predicate a step, no
// branch). If one was, or the palette is not tame, the block's lanes run
// again from their start in a separate (not inlined) function that tests
// each query, and overwrite their labels: the checked copy stays out of
// the steps' code, whose registers and schedule are the kernel's without
// the rule.
template <int G, int kPer>
__global__ void dither_kernel(const float* __restrict__ x0,
                              const float* __restrict__ x1,
                              const float* __restrict__ x2,
                              const int* __restrict__ perm,
                              const float4* __restrict__ table,
                              const float* __restrict__ params, int n, int k,
                              int seg, int lanes, int* __restrict__ out) {
  // an entry that is not pt_tame (NaN |c|^2 too), or a raw colour that is
  // not small3
  bool wild = false;
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const float4 c = table[2 * (size_t)e];
    const float4 raw = table[2 * (size_t)e + 1];
    wild |= !pt_tame(c.x, c.y, c.z) || isnan(c.w) ||
            !small3(raw.x, raw.y, raw.z);
  }
  const bool wild_palette = __syncthreads_or(wild);
  bool seen = false;
  if (!wild_palette) {
    seen = dither_lanes<G, kPer, false>(x0, x1, x2, perm, table, params, n,
                                        k, seg, lanes, out, false);
  }
  if (__syncthreads_or(wild_palette || seen)) {
    dither_lanes_checked<G, kPer>(x0, x1, x2, perm, table, params, n, k,
                                  seg, lanes, out, wild_palette);
  }
}

// entries a thread holds in registers: the fewest of 8, 16, 32 that hold
// k entries over G threads; 0 above 32 a thread (shared memory)
template <int G>
int regs_per_thread(int k) {
  const int per = (k + G - 1) / G;
  return per <= 8 ? 8 : per <= 16 ? 16 : per <= 32 ? 32 : 0;
}

template <int G, int kPer>
int launch_mode(const float* x0, const float* x1, const float* x2,
                const int* perm, const float* table, const float* params,
                int n, int k, int seg, int lanes, int* out,
                cudaStream_t stream) {
  static int done[PT_MAX_DEVICES] = {};
  const int threads = 64;
  const int per_block = threads / G;
  const int blocks = (lanes + per_block - 1) / per_block;
  const size_t stage = (size_t)per_block * kStageBytes;
  size_t smem;
  if (kPer > 0) {
    smem = (size_t)G * kPer * 12 + stage;
  } else if (kPer == 0) {
    smem = (size_t)round_up(k, G * kChains) * (16 + 12) + stage;
  } else {
    smem = (size_t)kTile * 16 + stage;
  }
  cudaError_t err = pt_opt_in_smem(dither_kernel<G, kPer>, (int)smem, done);
  if (err != cudaSuccess) return (int)err;
  dither_kernel<G, kPer><<<blocks, threads, smem, stream>>>(
      x0, x1, x2, perm, (const float4*)table, params, n, k, seg, lanes, out);
  return (int)cudaGetLastError();
}

template <int G>
int launch(const float* x0, const float* x1, const float* x2, const int* perm,
           const float* table, const float* params, int n, int k, int seg,
           int lanes, int* out, cudaStream_t stream) {
  switch (k > kTile ? -1 : regs_per_thread<G>(k)) {
    case 8:
      return launch_mode<G, 8>(x0, x1, x2, perm, table, params, n, k, seg,
                               lanes, out, stream);
    case 16:
      return launch_mode<G, 16>(x0, x1, x2, perm, table, params, n, k, seg,
                                lanes, out, stream);
    case 32:
      return launch_mode<G, 32>(x0, x1, x2, perm, table, params, n, k, seg,
                                lanes, out, stream);
    case 0:
      return launch_mode<G, 0>(x0, x1, x2, perm, table, params, n, k, seg,
                               lanes, out, stream);
    default:
      return launch_mode<G, -1>(x0, x1, x2, perm, table, params, n, k, seg,
                                lanes, out, stream);
  }
}

}  // namespace

// x0..x2: (n,) linear Rec2020 channels; perm: (n,) int32 visit order;
// table: (k, 8) f32 rows [pa, pb, pc, ps2, r0, r1, r2, 0]; params: the 16
// queue weights then the 3 channel weights; group: threads a lane (4, 8,
// 16 or 32); out: (n,) int32.
PT_EXPORT int pt_dither_scan(const float* x0, const float* x1, const float* x2,
                             const int* perm, const float* table,
                             const float* params, int n, int k, int seg,
                             int lanes, int group, int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (group) {
    case 4:
      return launch<4>(x0, x1, x2, perm, table, params, n, k, seg, lanes, out,
                       s);
    case 8:
      return launch<8>(x0, x1, x2, perm, table, params, n, k, seg, lanes, out,
                       s);
    case 16:
      return launch<16>(x0, x1, x2, perm, table, params, n, k, seg, lanes,
                        out, s);
    case 32:
      return launch<32>(x0, x1, x2, perm, table, params, n, k, seg, lanes,
                        out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
