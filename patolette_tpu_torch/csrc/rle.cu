// K6: run-length encode of a u8 LUT slice into the v2 wire format.
//
// Replaces patolette_tpu/ops/lut.py::_rle_encode_u8_v2 (lut.py:206-267).
// The input is a u8 table slice of L codes, L a multiple of 128 (a rank's
// 2^24 / world codes on the multi-device route). A position i starts a run
// when x[i] != x[i-1], and at every 128th position (forced, so that every
// delta fits 8 bits). Output, u16 words:
//   [count & 0xFFFF, count >> 16, overflow, w_0 .. w_{count-1}]
// with w_i = ((pos_i - pos_{i-1}) << 8) | x[pos_i] and pos_0 = 0. overflow
// is set when a 128-block has more than 32 run starts or count > 2^21 - 1;
// the reader then takes the slice raw and reads no word.
//
// The JAX package compacts with two sorts (a per-row sort of keyed
// columns, then a global sort of the survivors). Ascending key order is
// ascending position order, so an ordered compaction gives the same words.
// The 128-blocks ("rows") are taken in groups of 256, one thread block of 8
// warps a group, each warp 32 rows:
//   rle_count: per row, each lane holds 4 bytes (one uchar4 load), flags by
//     compare with its neighbour (shfl for the lane's first byte), the
//     row's run count by warp reduce and the offset of its last run start;
//     per group, the sum and the largest row count;
//   rle_scan: one block; an exclusive scan of the group sums (integer, so
//     exact and deterministic), the header and the overflow flag;
//   rle_write: per group, an exclusive block scan of its 256 row counts
//     from the group's offset; per row, each lane writes its words at the
//     row's offset plus the exclusive warp scan of the lanes' counts. A
//     row's first delta reaches back to the last run start of the row
//     before it. Rows over 32 starts write nothing (the header tells the
//     reader not to read).
// Bound on the H100: bytes. It reads L bytes and writes 2 (3 + count):
// at L = 2^24 and ~600k runs, ~18 MB, ~5.4 us at 3.35 TB/s. The scan walks
// L / 32768 group sums (512 at L = 2^24).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kForce = 128;             // forced run start every kForce
constexpr int kCols = 32;               // most run starts a block may hold
constexpr int kMaxRuns = (1 << 21) - 1;
constexpr int kWarps = 8;                 // warps a block
constexpr int kGroup = kWarps * 32;       // rows a block
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// This lane's 4 bytes of row `row` and their run-start bits (bit j: byte
// lane * 4 + j starts a run).
__device__ __forceinline__ unsigned start_bits(const uint8_t* __restrict__ x,
                                               int row, int lane,
                                               uchar4* v_out) {
  const uchar4 v =
      reinterpret_cast<const uchar4*>(x + (size_t)row * kForce)[lane];
  const unsigned prev = __shfl_up_sync(kFull, (unsigned)v.w, 1);
  unsigned bits = (lane == 0 || v.x != prev) ? 1u : 0u;
  bits |= (v.y != v.x) ? 2u : 0u;
  bits |= (v.z != v.y) ? 4u : 0u;
  bits |= (v.w != v.z) ? 8u : 0u;
  *v_out = v;
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

__global__ void rle_count(const uint8_t* __restrict__ x, int rows,
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
    uchar4 v;
    const unsigned bits = start_bits(x, row, lane, &v);
    const int total = __reduce_add_sync(kFull, __popc(bits));
    const int lst = __reduce_max_sync(kFull, last_start(bits, lane));
    if (lane == 0) {
      counts[row] = total;
      last[row] = (uint8_t)lst;
    }
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

__global__ void rle_scan(const int* __restrict__ group_sum,
                         const int* __restrict__ group_max, int groups,
                         int* __restrict__ group_off,
                         uint16_t* __restrict__ out) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int chunk = (groups + kScanThreads - 1) / kScanThreads;
  const int g0 = min(groups, tid * chunk), g1 = min(groups, g0 + chunk);
  int local = 0;
  int over = 0;
  for (int g = g0; g < g1; ++g) {
    local += group_sum[g];
    over |= group_max[g] > kCols;
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
  if (tid == 0) {
    const int total = warp_sums[kScanThreads / 32 - 1];
    out[0] = (uint16_t)(total & 0xFFFF);
    out[1] = (uint16_t)((unsigned)total >> 16);
    out[2] = (uint16_t)(over || total > kMaxRuns);
  }
}

__global__ void rle_write(const uint8_t* __restrict__ x, int rows,
                          const int* __restrict__ counts,
                          const uint8_t* __restrict__ last,
                          const int* __restrict__ group_off,
                          uint16_t* __restrict__ out, long long n_words) {
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
    const long long base = 3 + (long long)s_off[i];
    if (cnt > kCols || base + cnt > n_words) continue;
    uchar4 v;
    const unsigned bits = start_bits(x, row, lane, &v);
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
    if (lane == 0) {
      // the row's first start is forced; it reaches back into the row
      // before (delta 0 for the slice's first run)
      prev = row == 0 ? 0 : (int)last[row - 1] - kForce;
    }
    long long at = base + incl - mine;
    const uint8_t vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (bits & (1u << j)) {
        const int pos = lane * 4 + j;
        out[at++] = (uint16_t)(((pos - prev) << 8) | vals[j]);
        prev = pos;
      }
    }
  }
}

}  // namespace

// x: (L,) u8, 4-byte aligned, L = rows * 128; counts: (rows,) int32 and
// last: (rows,) u8 scratch; groups: (3 * ceil(rows / 256),) int32 scratch;
// out: (n_words,) u16 with n_words >= 3 + rows * 32.
PT_EXPORT int pt_rle_encode_u8_v2(const uint8_t* x, int rows, int* counts,
                                  uint8_t* last, int* groups, uint16_t* out,
                                  long long n_words, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows < 1 || n_words < 3 + (long long)rows * kCols) return 1;
  const int ng = (rows + kGroup - 1) / kGroup;
  int* group_sum = groups;
  int* group_max = groups + ng;
  int* group_off = groups + 2 * ng;
  rle_count<<<ng, kGroup, 0, st>>>(x, rows, counts, last, group_sum,
                                   group_max);
  rle_scan<<<1, kScanThreads, 0, st>>>(group_sum, group_max, ng, group_off,
                                       out);
  rle_write<<<ng, kGroup, 0, st>>>(x, rows, counts, last, group_off, out,
                                   n_words);
  return (int)cudaGetLastError();
}
