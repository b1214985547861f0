// K6: run-length encode of a LUT table into the three wire formats of the
// JAX package's pull_lut.
//
// Replaces patolette_tpu/ops/lut.py::_rle_encode_u8_v2 (lut.py:206-267),
// _rle_encode_u8 (v1, lut.py:187-203) and _rle_encode_u16_v2
// (lut.py:270-310). The input is a table of L entries, L a multiple of 128
// (a rank's 2^24 / world codes on the multi-device route, the whole 2^24
// table on the single-device pull). A position i starts a run when
// x[i] != x[i-1]. The formats (struct V2U8, V1U8, V2U16 below):
//   v2 (u8 table, u16 words): a start forced at every 128th position, so
//     that every delta fits 8 bits; [count & 0xFFFF, count >> 16, overflow,
//     w_0 .. w_{count-1}], w_i = ((pos_i - pos_{i-1}) << 8) | x[pos_i],
//     pos_0 = 0; overflow when a 128-block has more than 32 starts or
//     count > 2^21 - 1;
//   v1 (u8 table, u32 words): no forced start and no per-block cap;
//     [count, w_0 .. w_{n-1}], w_i = (pos_i << 8) | x[pos_i], written for
//     i < 2^21 - 1 only, while count stays exact (the reader takes the
//     table raw when count > 2^21 - 1). The word of a one-entry run of 255
//     at 2^24 - 1 is 0xFFFFFFFF, a valid word;
//   u16 v2 (u16 table, u32 words): v2's forced starts and cap;
//     [count, overflow, w_0 ..], w_i = ((pos_i - pos_{i-1}) << 16) | x[pos_i].
// Where overflow is set the words are not to be read.
//
// The JAX package compacts with sorts (v2: a per-row sort of keyed columns,
// then a global sort of the survivors; v1: one global sort of the keys).
// Ascending key order is ascending position order, so an ordered compaction
// gives the same words. The 128-blocks ("rows") are taken in groups of 256,
// one thread block of 8 warps a group, each warp 32 rows:
//   rle_count: per row, each lane holds 4 entries (one uchar4 or ushort4
//     load), flags by compare with its neighbour (shfl for the lane's first
//     entry; lane 0 of an unforced format reads the entry before the row),
//     the row's run count by warp reduce and the offset of its last run
//     start; per group, the sum and the largest row count;
//   rle_scan: one block; an exclusive scan of the group sums (integer, so
//     exact and deterministic), the header and the overflow flag;
//   rle_write: per group, an exclusive block scan of its 256 row counts
//     from the group's offset; per row, each lane writes its words at the
//     row's offset plus the exclusive warp scan of the lanes' counts. In a
//     delta format a row's first delta reaches back to the last run start
//     of the row before it. Rows over the cap write nothing, and no word
//     is written past the buffer.
// Bound on the H100: bytes. It reads the table once and writes the header
// and count words: at L = 2^24 and ~600k runs, v2 ~18 MB (~5.4 us at
// 3.35 TB/s), v1 ~19 MB, u16 ~36 MB. The scan walks L / 32768 group sums
// (512 at L = 2^24).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kForce = 128;             // entries a row (a 128-block)
constexpr int kMaxRuns = (1 << 21) - 1;
constexpr int kWarps = 8;                 // warps a block
constexpr int kGroup = kWarps * 32;       // rows a block
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// The formats. T: table entry; W: word; kForced: a start at every row's
// first entry; kCap: most starts a row may hold (overflow above);
// kHeader: header words; word(): the word of a start at row-relative
// position pos (prev: the previous start, row-relative; base: the row's
// first position); header(): the header words.
struct V2U8 {
  using T = uint8_t;
  using W = uint16_t;
  static constexpr bool kForced = true;
  static constexpr int kCap = 32;
  static constexpr int kHeader = 3;
  __device__ static W word(long long, int pos, int prev, T v) {
    return (W)(((pos - prev) << 8) | v);
  }
  __device__ static void header(W* out, int total, bool over) {
    out[0] = (W)(total & 0xFFFF);
    out[1] = (W)((unsigned)total >> 16);
    out[2] = (W)(over || total > kMaxRuns);
  }
};

struct V1U8 {
  using T = uint8_t;
  using W = uint32_t;
  static constexpr bool kForced = false;
  static constexpr int kCap = kForce;
  static constexpr int kHeader = 1;
  __device__ static W word(long long base, int pos, int, T v) {
    return (W)(((uint32_t)(base + pos) << 8) | v);
  }
  __device__ static void header(W* out, int total, bool) {
    out[0] = (W)total;
  }
};

struct V2U16 {
  using T = uint16_t;
  using W = uint32_t;
  static constexpr bool kForced = true;
  static constexpr int kCap = 32;
  static constexpr int kHeader = 2;
  __device__ static W word(long long, int pos, int prev, T v) {
    return ((W)(pos - prev) << 16) | v;
  }
  __device__ static void header(W* out, int total, bool over) {
    out[0] = (W)total;
    out[1] = (W)(over || total > kMaxRuns);
  }
};

// One lane's 4 entries of a row, in one 4- or 8-byte load.
__device__ __forceinline__ void load4(const uint8_t* p, uint8_t v[4]) {
  const uchar4 q = *reinterpret_cast<const uchar4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const uint16_t* p, uint16_t v[4]) {
  const ushort4 q = *reinterpret_cast<const ushort4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// This lane's 4 entries of row `row` and their run-start bits (bit j: entry
// lane * 4 + j starts a run).
template <class F>
__device__ __forceinline__ unsigned start_bits(const typename F::T* __restrict__ x,
                                               int row, int lane,
                                               typename F::T v[4]) {
  const typename F::T* p = x + (size_t)row * kForce;
  load4(p + lane * 4, v);
  unsigned prev = __shfl_up_sync(kFull, (unsigned)v[3], 1);
  bool first;
  if constexpr (F::kForced) {
    first = lane == 0 || v[0] != prev;
  } else {
    if (lane == 0 && row > 0) prev = p[-1];
    first = (lane == 0 && row == 0) || v[0] != prev;
  }
  unsigned bits = first ? 1u : 0u;
  bits |= (v[1] != v[0]) ? 2u : 0u;
  bits |= (v[2] != v[1]) ? 4u : 0u;
  bits |= (v[3] != v[2]) ? 8u : 0u;
  return bits;
}

// Offset in the row of the lane's last run start, or -1.
__device__ __forceinline__ int last_start(unsigned bits, int lane) {
  return bits ? lane * 4 + (31 - __clz(bits)) : -1;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// last: per row, the offset of its last start (delta formats only).
template <class F>
__global__ void rle_count(const typename F::T* __restrict__ x, int rows,
                          int* __restrict__ counts,
                          uint8_t* __restrict__ last,
                          int* __restrict__ group_sum,
                          int* __restrict__ group_max) {
  __shared__ int s_sum[kWarps], s_max[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kGroup + warp * 32;
  int sum = 0, most = 0;
  for (int k = 0; k < 32 && r0 + k < rows; ++k) {  // warp-uniform
    const int row = r0 + k;
    typename F::T v[4];
    const unsigned bits = start_bits<F>(x, row, lane, v);
    const int total = __reduce_add_sync(kFull, __popc(bits));
    if constexpr (F::kForced) {
      const int lst = __reduce_max_sync(kFull, last_start(bits, lane));
      if (lane == 0) last[row] = (uint8_t)lst;
    }
    if (lane == 0) counts[row] = total;
    sum += total;
    most = max(most, total);
  }
  if (lane == 0) {
    s_sum[warp] = sum;
    s_max[warp] = most;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int gs = 0, gm = 0;
    for (int w = 0; w < kWarps; ++w) {
      gs += s_sum[w];
      gm = max(gm, s_max[w]);
    }
    group_sum[blockIdx.x] = gs;
    group_max[blockIdx.x] = gm;
  }
}

template <class F>
__global__ void rle_scan(const int* __restrict__ group_sum,
                         const int* __restrict__ group_max, int groups,
                         int* __restrict__ group_off,
                         typename F::W* __restrict__ out) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int chunk = (groups + kScanThreads - 1) / kScanThreads;
  const int g0 = min(groups, tid * chunk), g1 = min(groups, g0 + chunk);
  int local = 0;
  int over = 0;
  for (int g = g0; g < g1; ++g) {
    local += group_sum[g];
    over |= group_max[g] > F::kCap;
  }
  const int v = warp_incl_scan(local, lane);
  if (lane == 31) warp_sums[warp] = v;
  over = __syncthreads_or(over);
  if (warp == 0) warp_sums[lane] = warp_incl_scan(warp_sums[lane], lane);
  __syncthreads();
  int acc = v - local + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int g = g0; g < g1; ++g) {
    group_off[g] = acc;
    acc += group_sum[g];
  }
  if (tid == 0) F::header(out, warp_sums[kScanThreads / 32 - 1], over);
}

template <class F>
__global__ void rle_write(const typename F::T* __restrict__ x, int rows,
                          const int* __restrict__ counts,
                          const uint8_t* __restrict__ last,
                          const int* __restrict__ group_off,
                          typename F::W* __restrict__ out, long long n_words) {
  __shared__ int s_off[kGroup];
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g0 = blockIdx.x * kGroup;
  // exclusive scan of the group's row counts, from the group's offset
  const int mine_row = g0 + threadIdx.x;
  const int c = mine_row < rows ? counts[mine_row] : 0;
  const int incl_row = warp_incl_scan(c, lane);
  if (lane == 31) s_warp[warp] = incl_row;
  __syncthreads();
  int base_w = group_off[blockIdx.x];
  for (int w = 0; w < warp; ++w) base_w += s_warp[w];
  s_off[threadIdx.x] = base_w + incl_row - c;
  __syncthreads();

  for (int k = 0; k < 32; ++k) {  // warp-uniform
    const int i = warp * 32 + k;
    const int row = g0 + i;
    if (row >= rows) break;
    const int cnt = counts[row];
    const long long at0 = F::kHeader + (long long)s_off[i];
    if (cnt == 0 || cnt > F::kCap || at0 >= n_words) continue;
    typename F::T v[4];
    const unsigned bits = start_bits<F>(x, row, lane, v);
    const int mine = __popc(bits);
    int incl = mine;  // inclusive scans: word counts, last start
    int lst = last_start(bits, lane);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      const int m = __shfl_up_sync(kFull, lst, o);
      if (lane >= o) {
        incl += t;
        lst = max(lst, m);
      }
    }
    int prev = __shfl_up_sync(kFull, lst, 1);  // last start of lower lanes
    if (F::kForced && lane == 0) {
      // the row's first start is forced; it reaches back into the row
      // before (delta 0 for the table's first run)
      prev = row == 0 ? 0 : (int)last[row - 1] - kForce;
    }
    const long long base = (long long)row * kForce;
    long long at = at0 + incl - mine;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (bits & (1u << j)) {
        const int pos = lane * 4 + j;
        if (at < n_words) out[at] = F::word(base, pos, prev, v[j]);
        ++at;
        prev = pos;
      }
    }
  }
}

// x: (rows * 128,) entries, 4-byte (u8) or 8-byte (u16) aligned; counts:
// (rows,) int32 and last: (rows,) u8 scratch (delta formats; NULL for v1);
// groups: (3 * ceil(rows / 256),) int32 scratch; out: (n_words,) words.
template <class F>
int encode(const typename F::T* x, int rows, int* counts, uint8_t* last,
           int* groups, typename F::W* out, long long n_words,
           cudaStream_t st) {
  if (rows < 1 || n_words < F::kHeader) return 1;
  if (F::kForced && (last == nullptr ||
                     n_words < F::kHeader + (long long)rows * F::kCap)) {
    return 1;
  }
  const int ng = (rows + kGroup - 1) / kGroup;
  int* group_sum = groups;
  int* group_max = groups + ng;
  int* group_off = groups + 2 * ng;
  rle_count<F><<<ng, kGroup, 0, st>>>(x, rows, counts, last, group_sum,
                                      group_max);
  rle_scan<F><<<1, kScanThreads, 0, st>>>(group_sum, group_max, ng,
                                          group_off, out);
  rle_write<F><<<ng, kGroup, 0, st>>>(x, rows, counts, last, group_off, out,
                                      n_words);
  return (int)cudaGetLastError();
}

}  // namespace

// v2: out (n_words,) u16, n_words >= 3 + rows * 32.
PT_EXPORT int pt_rle_encode_u8_v2(const uint8_t* x, int rows, int* counts,
                                  uint8_t* last, int* groups, uint16_t* out,
                                  long long n_words, void* stream) {
  return encode<V2U8>(x, rows, counts, last, groups, out, n_words,
                      (cudaStream_t)stream);
}

// v1: out (n_words,) u32; words past n_words are not written.
PT_EXPORT int pt_rle_encode_u8(const uint8_t* x, int rows, int* counts,
                               int* groups, uint32_t* out, long long n_words,
                               void* stream) {
  if ((long long)rows * kForce > (1LL << 24)) return 1;  // pos << 8 in 32 bits
  return encode<V1U8>(x, rows, counts, nullptr, groups, out, n_words,
                      (cudaStream_t)stream);
}

// u16 v2: out (n_words,) u32, n_words >= 2 + rows * 32.
PT_EXPORT int pt_rle_encode_u16_v2(const uint16_t* x, int rows, int* counts,
                                   uint8_t* last, int* groups, uint32_t* out,
                                   long long n_words, void* stream) {
  return encode<V2U16>(x, rows, counts, last, groups, out, n_words,
                       (cudaStream_t)stream);
}
