// K11: the GQ dynamic program, Wu's optimal 1-D partition of the 512
// projection buckets into at most 12 cells, and its backtrack.
//
// Replaces patolette_tpu/models/global_q.py::gq_device (:205-264): the
// prefix moments, D[t, n] = _pairwise_cell_distortion (:55-69), the levels
// E_k[n] = min_{k-1 <= t <= n-1} E_{k-1}[t] + D(t, n) for k = 2 .. k_max,
// their cut rows (the LARGEST minimising t, as the JAX package's argmin
// over the reversed rows), and every level's chain (chain_scan, :242-262).
// The termination test that picks the level stays torch glue
// (models/global_q.py of the port).
//
// Bound on the H100: neither bytes (b x 11 floats in, a few tables out)
// nor operations (the 131K cells D(t, n), which do not depend on the
// level, at 12 f32 operations each, then ~1.41M (t, n, k) candidates at
// 2 each: ~0.13 us) but the chain: the 11 levels depend on each other,
// and a level is a minimum over up to 512 candidates (~0.45 us).
//
// Design: one thread block cluster of kCluster = 16 blocks (the fastest
// of C = 4, 8, 16 in chip_smoke.py's sweep; 16 is the non-portable
// maximum) on 16 SMs, 1024 threads a block. Block r owns the columns n =
// r (mod C), whose triangles {t < n} hold nearly equal work.
//   1. Every block sums the prefix itself, row by row in f32, lanes 0..4
//      of warp 0 the five moments D reads, from the bucket moments staged
//      in shared memory (the next 8 rows loaded before the current 8
//      adds); in block 0, warp 1 sums all 11 again (the same bits) into
//      the output.
//   2. D(t, n) for the block's own columns, t < n, computed once into
//      shared memory, column after column (lanes on consecutive t, so on
//      consecutive banks), each column in two halves dealt to the warps
//      from the longest down in snake order (warps 0, 1, .., W-1, then
//      W-1, .., 0). The IEEE division leaves the levels' chain. The warp
//      of a column's first half also sends level 1, D(0, n).
//   3. Each level: a warp a column (the same snake order), lane l
//      scanning t = n-1-l, n-33-l, .. with the running rule below; the
//      warp's minimum of an order key (two __reduce_min_sync, which beat
//      a 5-step __shfl_xor_sync tree on the card); the winner's own value
//      from its lane. Lanes 0..C-1 send E_k[n] into block l's copy of the
//      level row, lane 31 the cut into block 0's cut table, each with
//      st.async, which counts its 4 bytes on the receiving block's level
//      barrier (an mbarrier; level k's on barrier (k-1) & 1, with row
//      (k-1) & 1). A block waits on its own barrier until every value of
//      the level has arrived; no cluster barrier, and no fence, on the
//      levels' chain. Two rows suffice: a block sends level k+1's values
//      only after all of level k's arrived, and each block sent its level
//      k values only after its warps had read level k-1's row, which
//      level k+1 overwrites. A barrier's next phase is armed (its expected
//      bytes) before this block sends anything of the level that lets the
//      others reach it.
//   4. Block 0 backtracks the <= 12 chains from its full cut table.
// One cluster barrier, after every block has initialised its level
// barriers, precedes the first send. A block exits once its own barriers
// have counted every store into it, and the stores it sends need nothing
// of its shared memory, so no block exits while another may still reach
// its shared memory.
//
// Bits: every operation is rounded on its own (no FMA contraction), in the
// plain version's order (kernels/gq.py::gq_dp_plain): the prefix summed
// row by row; s = (dx dx + dy dy) + dz dz; d = dw2 - s / dw0; D = d where
// dw0 > 0 (then 0 below 0, NaN kept), else 0; the candidate cost
// E_{k-1}[t] + D(t, n). The minimum follows jnp.min and the argmin of the
// reversed row, stated as one total order on (NaN, c, t), so that any
// order of reduction gives the same (cost, cut). Candidate a = (c_a, t_a)
// beats b when
//   - exactly one of the two is NaN, and it is a; or
//   - both are NaN and t_a > t_b; or
//   - neither is NaN and c_a < c_b; or
//   - neither is NaN, c_a == c_b (-0 against +0, +inf against +inf) and
//     t_a > t_b.
// Every lane and the reduction start from the identity (+inf, t = b); b exceeds
// every valid t, so a column whose candidates are all +inf, or that has
// none, keeps cost +inf and cut b (the reversed argmin of a row that is
// +inf everywhere picks t = b). A lane visits its t in descending order
// after the identity, so a new candidate always has the smaller t and the
// rule reduces to: take it when the best so far is not NaN and !(c >=
// best). The reduction compares 64-bit keys whose unsigned order is the rule:
// high word 0 for NaN, else the float's order bits with -0 read as +0;
// low word ~t. The value stored is the winner's own value.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 12;
constexpr int kMoments = 11;
// The prefix moments D reads (w0, the three first moments, w2).
constexpr int kUsed = 5;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Blocks of the cluster (the sweep of C = 4, 8, 16 on the H100: PERF.md).
constexpr int kCluster = 16;
// Rows of the prefix loaded ahead of the additions (the staged moments
// are followed by kAhead zero rows, so the loads need no bound check).
constexpr int kAhead = 8;
// A level wait that spins this many times traps instead of hanging.
constexpr long long kMaxSpins = 1ll << 22;

__device__ __forceinline__ float cell_d(const float* pt, float w0n, float ax,
                                        float ay, float az, float w2n) {
  const float dw0 = __fsub_rn(w0n, pt[0]);
  const float dx = __fsub_rn(ax, pt[1]);
  const float dy = __fsub_rn(ay, pt[2]);
  const float dz = __fsub_rn(az, pt[3]);
  const float dw2 = __fsub_rn(w2n, pt[4]);
  const bool nonempty = dw0 > 0.0f;
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  const float d = __fsub_rn(dw2, __fdiv_rn(s, nonempty ? dw0 : 1.0f));
  return nonempty ? ((d > 0.0f || isnan(d)) ? d : 0.0f) : 0.0f;
}

// The candidate (v, t) as a key whose unsigned order is the rule above
// (the smaller key wins).
__device__ __forceinline__ unsigned long long order_key(float v, int t) {
  unsigned u = __float_as_uint(v);
  u = (u << 1) == 0u ? 0u : u;  // -0 as +0
  const unsigned hi =
      isnan(v) ? 0u : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
  return ((unsigned long long)hi << 32) | (unsigned)~(unsigned)t;
}

// The warp's smallest key: the smallest high word, then the smallest low
// word among the lanes that hold it.
__device__ __forceinline__ unsigned long long warp_min(unsigned long long key) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned min_hi = __reduce_min_sync(PT_FULL, hi);
  const unsigned min_lo =
      __reduce_min_sync(PT_FULL, hi == min_hi ? lo : 0xffffffffu);
  return ((unsigned long long)min_hi << 32) | min_lo;
}

// Distributed shared memory and the level barriers (PTX).
__device__ __forceinline__ unsigned cta_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of the same byte in block `rank`'s shared memory.
__device__ __forceinline__ unsigned peer_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// This block's one arrival of the barrier's next phase, which also waits
// for `bytes` of stores.
__device__ __forceinline__ void bar_arm(unsigned bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}"
      ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  long long spins = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && ++spins > kMaxSpins) __trap();
  } while (!done);
}

// 4 bytes into another block's shared memory, counted on its barrier.
__device__ __forceinline__ void send(unsigned addr, unsigned bits,
                                     unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr), "r"(bits), "r"(bar) : "memory");
}

// Columns of block r: n = r, r + c, .. <= b.
__host__ __device__ __forceinline__ int block_columns(int b, int r, int c) {
  return r <= b ? (b - r) / c + 1 : 0;
}

// Cells of D before block r's local column j (columns n = r + i c, i < j,
// each of n cells).
__host__ __device__ __forceinline__ int d_offset(int j, int r, int c) {
  return j * r + c * (j * (j - 1) / 2);
}

// Item i of warp w in snake order (round 0 to warps 0, 1, .., round 1 to
// warps W-1, W-2, ..), or -1: items listed from the longest down get each
// warp a nearly equal sum, a last, partial round the shortest.
__device__ __forceinline__ int snake(int q, int w, int items) {
  const int i = (q & 1) ? (q + 1) * kWarps - 1 - w : q * kWarps + w;
  return i < items ? i : -1;
}

__host__ __device__ __forceinline__ int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Shared memory, in bytes from its start: two level barriers; the prefix
// rows (b+1, kUsed) f32; two level rows of b+1 f32; the cut table
// (k_max+1, b+1) int32 of every column (block 0's is used); the block's
// own columns' level costs (k_max, ncl) f32; then D (first the staged
// bucket moments and kAhead zero rows).
struct Layout {
  int prefix, e0, e1, cuts, cost, d;
};

__host__ __device__ __forceinline__ Layout layout(int b, int k_max, int c) {
  const int cols = b + 1;
  Layout l;
  l.prefix = 16;
  l.e0 = l.prefix + align16(cols * kUsed * 4);
  l.e1 = l.e0 + align16(cols * 4);
  l.cuts = l.e1 + align16(cols * 4);
  l.cost = l.cuts + align16((k_max + 1) * cols * 4);
  l.d = l.cost + align16(k_max * block_columns(b, 0, c) * 4);
  return l;
}

size_t smem_bytes(int b, int k_max, int c) {
  int most = (b + kAhead) * kMoments;
  for (int r = 0; r < c; ++r) {
    const int cells = d_offset(block_columns(b, r, c), r, c);
    most = cells > most ? cells : most;
  }
  return (size_t)layout(b, k_max, c).d + (size_t)most * 4;
}

// One column of the prefix, summed in row order by one thread: src holds
// the b bucket moments' column (rows kMoments apart, then kAhead zero
// rows); rows 1..b go to dst, rows `stride` apart (row 0 is the caller's).
template <int stride>
__device__ __forceinline__ void prefix_column(const float* __restrict__ src,
                                              float* __restrict__ dst, int b) {
  float next[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) next[i] = src[i * kMoments];
  src += kAhead * kMoments;
  dst += stride;
  float acc = 0.0f;
  int r0 = 0;
  for (; r0 + kAhead <= b; r0 += kAhead) {
    float cur[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      cur[i] = next[i];
      next[i] = src[i * kMoments];
    }
    src += kAhead * kMoments;
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      acc = __fadd_rn(acc, cur[i]);
      dst[i * stride] = acc;
    }
    dst += kAhead * stride;
  }
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (r0 + i < b) {
      acc = __fadd_rn(acc, next[i]);
      dst[i * stride] = acc;
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
    gq_dp_kernel(const float* __restrict__ bm, int b, int k_max,
                 float* __restrict__ prefix_out, float* __restrict__ cost_out,
                 int* __restrict__ cut_out, int* __restrict__ chains_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int cols = b + 1;
  const Layout l = layout(b, k_max, C);
  float* prefix = reinterpret_cast<float*>(smem + l.prefix);
  float* e0 = reinterpret_cast<float*>(smem + l.e0);
  float* e1 = reinterpret_cast<float*>(smem + l.e1);
  int* cuts = reinterpret_cast<int*>(smem + l.cuts);
  float* cost = reinterpret_cast<float*>(smem + l.cost);
  float* dtab = reinterpret_cast<float*>(smem + l.d);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ncl = block_columns(b, r, C);
  const int rounds = (ncl + kWarps - 1) / kWarps;
  // Level k's values (and, in block 0, its cut row) arrive in row
  // (k - 1) & 1 and are counted on barrier (k - 1) & 1.
  const unsigned bar0 = cta_addr(smem), bar1 = bar0 + 8;
  const unsigned row_bytes = 4u * cols;
  const unsigned level_bytes = row_bytes + (r == 0 ? row_bytes : 0u);
  if (tid == 0) {
    bar_init(bar0);
    bar_init(bar1);
    bar_arm(bar0, row_bytes);  // level 1: no cut row
    if (k_max >= 2) bar_arm(bar1, level_bytes);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The first cluster barrier's arrival; its wait, before the first store
  // into another block, makes sure every block has started and
  // initialised its barriers.
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");

  // 1. The prefix, from the moments staged where D goes: warp 0 sums the
  // columns D reads into shared memory; in block 0 warp 1 sums all 11
  // again (the same bits) into the output, beside it.
  for (int i = tid; i < (b + kAhead) * kMoments; i += kThreads) {
    dtab[i] = i < b * kMoments ? bm[i] : 0.0f;
  }
  if (tid < kUsed) prefix[tid] = 0.0f;
  if (r == 0 && tid < kMoments) prefix_out[tid] = 0.0f;
  __syncthreads();
  if (warp == 0 && lane < kUsed) {
    prefix_column<kUsed>(dtab + lane, prefix + lane, b);
  } else if (warp == 1 && r == 0 && lane < kMoments) {
    prefix_column<kMoments>(dtab + lane, prefix_out + lane, b);
  }
  __syncthreads();

  // Lane l < C sends the level values to block l, lane 31 the cut to
  // block 0.
  const unsigned peer = (unsigned)(lane % C);
  const unsigned pe0 = peer_addr(cta_addr(e0), peer);
  const unsigned pe1 = peer_addr(cta_addr(e1), peer);
  const unsigned pbar0 = peer_addr(bar0, peer), pbar1 = peer_addr(bar1, peer);
  const unsigned cuts0 = peer_addr(cta_addr(cuts), 0u);
  const unsigned cbar0 = peer_addr(bar0, 0u), cbar1 = peer_addr(bar1, 0u);
  asm volatile("barrier.cluster.wait;" ::: "memory");

  // 2. D of the block's own columns, each in two pieces (t below n/2, and
  // from n/2), the pieces from the longest down in snake order.
  for (int q = 0;; ++q) {
    const int i = snake(q, warp, 2 * ncl);
    if (q * kWarps >= 2 * ncl) break;
    if (i < 0) continue;
    const int j = ncl - 1 - (i >> 1);
    const int n = r + j * C;
    const int lo = (i & 1) ? n >> 1 : 0;
    const int hi = (i & 1) ? n : n >> 1;
    const float* pn = prefix + n * kUsed;
    const float w0n = pn[0], ax = pn[1], ay = pn[2], az = pn[3],
                w2n = pn[4];
    float* dcol = dtab + d_offset(j, r, C);
#pragma unroll 2
    for (int t = lo + lane; t < hi; t += 32) {
      dcol[t] = cell_d(prefix + t * kUsed, w0n, ax, ay, az, w2n);
    }
    if ((i & 1) == 0) {  // level 1: one cell (0, n], D(0, n) again
      const float v = cell_d(prefix, w0n, ax, ay, az, w2n);
      if (lane < C) send(pe0 + 4u * n, __float_as_uint(v), pbar0);
      if (lane == 0) cost[j] = v;
    }
  }

  bar_wait(bar0, 0u);
  if (tid == 0 && k_max >= 3) bar_arm(bar0, level_bytes);
  __syncthreads();

  // 3. The levels: level k reads row k & 1 (level k-1's values).
  for (int k = 2; k <= k_max; ++k) {
    const float* e_prev = (k & 1) ? e1 : e0;
    const unsigned pnext = (k & 1) ? pe0 : pe1;
    const unsigned pbar = (k & 1) ? pbar0 : pbar1;
    const unsigned cbar = (k & 1) ? cbar0 : cbar1;
    for (int q = 0; q < rounds; ++q) {
      const int i = snake(q, warp, ncl);
      if (i < 0) continue;
      const int j = ncl - 1 - i;
      const int n = r + j * C;
      float best = __int_as_float(0x7f800000);  // +inf
      int arg = b;
      if (n >= k) {  // candidates t = k-1 .. n-1; lane's t = n-1-lane-32i
        int t = n - 1 - lane;
        const float* ep = e_prev + t;
        const float* dp = dtab + d_offset(j, r, C) + t;
        // every lane's t is a candidate in all rounds but the last
#pragma unroll 2
        for (int it = (n - k + 32) >> 5; it > 1; --it) {
          const float c = __fadd_rn(*ep, *dp);
          const bool take = !isnan(best) && !(c >= best);
          best = take ? c : best;
          arg = take ? t : arg;
          t -= 32;
          ep -= 32;
          dp -= 32;
        }
        if (t >= k - 1) {
          const float c = __fadd_rn(*ep, *dp);
          const bool take = !isnan(best) && !(c >= best);
          best = take ? c : best;
          arg = take ? t : arg;
        }
      }
      const unsigned long long key = warp_min(order_key(best, arg));
      const int tw = (int)~(unsigned)(key & 0xffffffffull);
      const float won = __shfl_sync(PT_FULL, best, (n - 1 - tw) & 31);
      const float v = tw == b ? __int_as_float(0x7f800000) : won;
      if (lane < C) {
        send(pnext + 4u * n, __float_as_uint(v), pbar);
      } else if (lane == 31) {
        send(cuts0 + 4u * (k * cols + n), (unsigned)tw, cbar);
      }
      if (lane == 0) cost[(k - 1) * ncl + j] = v;
    }
    const unsigned bar = (k & 1) ? bar0 : bar1;
    bar_wait(bar, (unsigned)((k - 1) >> 1) & 1u);
    if (tid == 0 && k + 2 <= k_max) bar_arm(bar, level_bytes);
    __syncthreads();
  }

  // 4. The outputs: each block its columns' level costs; block 0 the cut
  // rows, and level k's chain [0, q1, .., q_{k-1}, b, ..]: t walks down
  // from b through the cut rows k, k-1, .., 2. Every store into this
  // block has arrived (its barriers counted them) and the stores it sent
  // need nothing of its shared memory, so no cluster barrier is needed
  // before the block exits.
  for (int i = tid; i < k_max * ncl; i += kThreads) {
    const int k1 = i / ncl, j = i - k1 * ncl;
    cost_out[k1 * cols + r + j * C] = cost[i];
  }
  if (r != 0) return;
  for (int i = tid; i < (k_max + 1) * cols; i += kThreads) {
    cut_out[i] = i < 2 * cols ? 0 : cuts[i];
  }
  if (tid < k_max) {
    const int k = tid + 1;
    int* chain = chains_out + tid * (kMaxK + 1);
    chain[0] = 0;
    for (int j = 1; j <= kMaxK; ++j) chain[j] = b;
    int t = b;
    for (int j = k - 1; j >= 1; --j) {
      t = cuts[(j + 1) * cols + t];
      chain[j] = t;
    }
  }
}

template <int C>
cudaError_t launch(const float* bm, int b, int k_max, float* prefix,
                   float* cost, int* cut, int* chains, cudaStream_t stream,
                   size_t smem) {
  static int smem_done[PT_MAX_DEVICES];
  cudaError_t err = pt_opt_in_smem(gq_dp_kernel<C>, (int)smem, smem_done);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(gq_dp_kernel<C>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gq_dp_kernel<C>, bm, b, k_max, prefix,
                            cost, cut, chains);
}

}  // namespace

// bm: (b, 11) f32 bucket moments. Outputs: prefix (b+1, 11) f32; cost
// (k_max, b+1) f32, row k-1 = E_k; cut (k_max+1, b+1) int32, rows 0 and 1
// zero, row k the cut row of level k; chains (k_max, 13) int32, row k-1
// the chain of level k. 1 <= k_max <= 12, b + 1 <= 1024. cluster: 4, 8 or
// 16 blocks, or 0 for kCluster.
PT_EXPORT int pt_gq_dp(const float* bm, int b, int k_max, int cluster,
                       float* prefix, float* cost, int* cut, int* chains,
                       void* stream) {
  if (b < 1 || b + 1 > 1024 || k_max < 1 || k_max > kMaxK) {
    return (int)cudaErrorInvalidValue;
  }
  // (more shared memory than a block may hold fails at the opt-in)
  const int c = cluster == 0 ? kCluster : cluster;
  const size_t smem = smem_bytes(b, k_max, c);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (c) {
    case 4:
      err = launch<4>(bm, b, k_max, prefix, cost, cut, chains, s, smem);
      break;
    case 8:
      err = launch<8>(bm, b, k_max, prefix, cost, cut, chains, s, smem);
      break;
    case 16:
      err = launch<16>(bm, b, k_max, prefix, cost, cut, chains, s, smem);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
