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
// gives the same words.
//
// Design: one launch, the table read once. The 128-blocks ("rows") are
// taken in groups of kGroup (256 u8 rows, 128 u16 rows: 32 KB), one thread
// block of 8 warps a group:
//   1. a block takes its group by an integer ticket, so the groups start in
//      order, and copies the group's entries into shared memory (16-byte
//      cp.async copies, all in flight at once);
//   2. per row, each lane takes 4 entries and flags the run starts by
//      comparing each with the one before (a shuffle for a lane's first
//      entry; in v1 lane 0 reads the entry before the row), and the warp
//      reduces the row's run count and the offset of its last start; the
//      group's row counts are scanned in the block;
//   3. the block publishes its group's run count, overflow bit and last
//      start as one self-flagging 64-bit word (an aggregate), then warp 0
//      looks back over the words of the groups before it, 128 at a time
//      (four loads a lane in flight), down to the nearest one that holds
//      an inclusive prefix, and publishes its own inclusive prefix. The
//      sums are integers, so the offsets are exact and the same whatever
//      order the blocks run in. The word of the group before also gives
//      the last start that the group's first delta reaches back to (delta
//      formats). A block waits only on groups of earlier tickets, which are
//      running; a wait that does not end (a fault) traps after 20 s
//      instead of hanging;
//   4. each warp writes its rows' words from the staged entries: a lane's
//      first word goes at the row's offset plus the starts of the lower
//      lanes, and its first delta reaches back to their last start, both
//      from four ballots of the row's start flags (bit l of ballot j: entry
//      4 l + j), with no shuffle chain. Rows over the cap write nothing,
//      and no word is written past the buffer;
//   5. the group with the last ticket writes the header (count and, in v2
//      and u16, the overflow flag) from its inclusive prefix; the block
//      that finishes last puts the status words and tickets back to 0, so
//      one scratch buffer serves every call.
// Bound on the H100: bytes. It reads the table once and writes the header
// and count words: at L = 2^24 and ~600k runs, v2 ~18 MB (~5.4 us at
// 3.35 TB/s), v1 ~19 MB, u16 ~36 MB.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kForce = 128;             // entries a row (a 128-block)
constexpr int kMaxRuns = (1 << 21) - 1;
constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// A group's status word (0: not yet published): the run count in bits
// 0-31 (the group's own, or with kInclusive the runs of every group up to
// it), the offset in its last row of its last run start in bits 32-38,
// overflow (a row over the cap; inclusive: in any group so far) in bit 61.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kOver = 1ull << 61;
constexpr unsigned long long kSpinLimitNs = 20000000000ull;
constexpr int kLook = 4;  // status words a lane reads a look-back round

// One lane's 4 entries of a row, in one 4- or 8-byte load.
__device__ __forceinline__ unsigned load4(const uint8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ uint2 load4(const uint16_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ unsigned ent(unsigned v, int j) {
  return (v >> (8 * j)) & 0xffu;
}

__device__ __forceinline__ unsigned ent(uint2 v, int j) {
  return ((j < 2 ? v.x : v.y) >> (16 * (j & 1))) & 0xffffu;
}

// The formats. T: table entry; P: a lane's 4 entries; W: word; kForced: a
// start at every row's first entry; kCap: most starts a row may hold
// (overflow above); kHeader: header words; word(): the word of a start at
// row-relative position pos (prev: the previous start, row-relative; base:
// the row's first position); header(): the header words; kGroup: rows a
// block takes, 32 KB of entries.
struct V2U8 {
  using T = uint8_t;
  using P = unsigned;
  using W = uint16_t;
  static constexpr bool kForced = true;
  static constexpr int kCap = 32;
  static constexpr int kHeader = 3;
  static constexpr int kGroup = 256;
  __device__ static W word(long long, int pos, int prev, unsigned v) {
    return (W)(((pos - prev) << 8) | v);
  }
  __device__ static void header(W* out, long long total, bool over) {
    out[0] = (W)(total & 0xFFFF);
    out[1] = (W)((unsigned long long)total >> 16);
    out[2] = (W)(over || total > kMaxRuns);
  }
};

struct V1U8 {
  using T = uint8_t;
  using P = unsigned;
  using W = uint32_t;
  static constexpr bool kForced = false;
  static constexpr int kCap = kForce;
  static constexpr int kHeader = 1;
  static constexpr int kGroup = 256;
  __device__ static W word(long long base, int pos, int, unsigned v) {
    return (W)(((uint32_t)(base + pos) << 8) | v);
  }
  __device__ static void header(W* out, long long total, bool) {
    out[0] = (W)total;
  }
};

struct V2U16 {
  using T = uint16_t;
  using P = uint2;
  using W = uint32_t;
  static constexpr bool kForced = true;
  static constexpr int kCap = 32;
  static constexpr int kHeader = 2;
  static constexpr int kGroup = 128;
  __device__ static W word(long long, int pos, int prev, unsigned v) {
    return ((W)(pos - prev) << 16) | v;
  }
  __device__ static void header(W* out, long long total, bool over) {
    out[0] = (W)total;
    out[1] = (W)(over || total > kMaxRuns);
  }
};

// Run-start bits of a lane's 4 entries v (bit j: entry lane * 4 + j);
// before: the entry before entry 0; first: entry 0 starts a run anyway.
template <class F>
__device__ __forceinline__ unsigned start_bits(typename F::P v,
                                               unsigned before, bool first) {
  unsigned bits = (first || ent(v, 0) != before) ? 1u : 0u;
  bits |= (ent(v, 1) != ent(v, 0)) ? 2u : 0u;
  bits |= (ent(v, 2) != ent(v, 1)) ? 4u : 0u;
  bits |= (ent(v, 3) != ent(v, 2)) ? 8u : 0u;
  return bits;
}

// A row's start flags as four ballots: bit l of bal[j] is entry 4 l + j.
struct RowBits {
  unsigned bal[4];
};

__device__ __forceinline__ RowBits row_ballots(unsigned bits) {
  RowBits r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r.bal[j] = __ballot_sync(kFull, (bits >> j) & 1u);
  }
  return r;
}

__device__ __forceinline__ int row_count(const RowBits& r, unsigned lanes) {
  return __popc(r.bal[0] & lanes) + __popc(r.bal[1] & lanes) +
         __popc(r.bal[2] & lanes) + __popc(r.bal[3] & lanes);
}

// Row offset of the last start among the entries of `lanes`, or -1.
__device__ __forceinline__ int row_last(const RowBits& r, unsigned lanes) {
  const unsigned any = (r.bal[0] | r.bal[1] | r.bal[2] | r.bal[3]) & lanes;
  if (any == 0) return -1;
  const int l = 31 - __clz(any);
  const int j = ((r.bal[3] >> l) & 1u)   ? 3
                : ((r.bal[2] >> l) & 1u) ? 2
                : ((r.bal[1] >> l) & 1u) ? 1
                                         : 0;
  return 4 * l + j;
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v));
}

// Spin until the group's word is published (a fault past kSpinLimitNs).
__device__ __noinline__ unsigned long long wait_word(
    const unsigned long long* p) {
  unsigned long long t0, t1, v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while ((v = load_word(p)) == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    if (t1 - t0 > kSpinLimitNs) __trap();
  }
  return v;
}

// 16 bytes from device to shared memory in the background (L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// This lane's 4 entries of row i of the staged group and their start bits
// (bit j: entry lane * 4 + j); row: the row's index in the table.
template <class F>
__device__ __forceinline__ unsigned row_bits(
    const typename F::T* tile, const typename F::T* __restrict__ x, int i,
    long long row, int lane, typename F::P& v) {
  v = load4(tile + i * kForce + lane * 4);
  unsigned before = __shfl_up_sync(kFull, ent(v, 3), 1);
  bool first = lane == 0;
  if constexpr (!F::kForced) {
    if (lane == 0 && row > 0) {  // the last entry of the row before
      before = i > 0 ? tile[i * kForce - 1] : x[row * kForce - 1];
    }
    first = lane == 0 && row == 0;
  }
  return start_bits<F>(v, before, first);
}

// status: (groups,) words, then the ticket and the finished count (two
// u32); all 0 before and after a launch. Dynamic shared memory: the
// group's entries.
template <class F>
__global__ void __launch_bounds__(kThreads)
    rle_encode(const typename F::T* __restrict__ x, int rows, int groups,
               typename F::W* __restrict__ out, long long n_words,
               unsigned long long* status) {
  using T = typename F::T;
  constexpr int kRows = F::kGroup / kWarps;  // rows a warp
  extern __shared__ uint4 staged[];
  __shared__ int s_cnt[F::kGroup];
  __shared__ int s_off[F::kGroup];
  __shared__ unsigned char s_last[F::kGroup];
  __shared__ int s_warp[kWarps];
  __shared__ int s_most[kWarps];
  __shared__ long long s_base;
  __shared__ int s_prev_last;
  __shared__ int s_g;
  __shared__ bool s_final;
  T* tile = reinterpret_cast<T*>(staged);
  unsigned* counters = reinterpret_cast<unsigned*>(status + groups);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_g = (int)atomicAdd(&counters[0], 1u);
  __syncthreads();
  const int g = s_g;
  const long long row0 = (long long)g * F::kGroup;
  const int in_group = (int)min((long long)F::kGroup, rows - row0);

  // 1: the group's entries into shared memory, 16 bytes a copy, all in
  // flight at once
  {
    const char* src = reinterpret_cast<const char*>(x + row0 * kForce);
    char* dst = reinterpret_cast<char*>(tile);
    const int bytes = in_group * kForce * (int)sizeof(T);
    for (int o = threadIdx.x * 16; o < bytes; o += kThreads * 16) {
      cp_async16(dst + o, src + o);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }

  // 2: per row, its run count and the offset of its last start
  int most = 0;
#pragma unroll 8
  for (int k = 0; k < kRows; ++k) {
    const int i = warp * kRows + k;
    if (i >= in_group) break;  // warp-uniform
    typename F::P v;
    const unsigned b = row_bits<F>(tile, x, i, row0 + i, lane, v);
    const int total = __reduce_add_sync(kFull, __popc(b));
    if constexpr (F::kForced) {
      const int last = b ? lane * 4 + (31 - __clz(b)) : -1;
      const int lst = __reduce_max_sync(kFull, last);
      if (lane == 0) s_last[i] = (unsigned char)lst;
    }
    if (lane == 0) s_cnt[i] = total;
    most = max(most, total);
  }
  if (lane == 0) s_most[warp] = most;
  __syncthreads();

  // the group's exclusive scan of its row counts; its aggregate
  const int c = (int)threadIdx.x < in_group ? s_cnt[threadIdx.x] : 0;
  const int incl = warp_incl_scan(c, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int base = 0, total = 0, over = 0;
  for (int w = 0; w < kWarps; ++w) {
    base += w < warp ? s_warp[w] : 0;
    total += s_warp[w];
    over |= s_most[w] > F::kCap;
  }
  if (threadIdx.x < F::kGroup) s_off[threadIdx.x] = base + incl - c;

  // 3: publish, look back, publish the inclusive prefix
  if (warp == 0) {
    const unsigned long long own =
        (unsigned)total | (over ? kOver : 0ull) |
        (F::kForced ? (unsigned long long)s_last[in_group - 1] << 32 : 0ull);
    if (lane == 0) store_word(&status[g], own | (g == 0 ? kInclusive
                                                        : kAggregate));
    long long excl = 0;
    bool over_before = false;
    int prev_last = 0;
    // rounds of kLook words a lane, 32 kLook groups, nearest first (lane
    // l, word i: group top - l - 32 i), down to the nearest inclusive word
    for (int top = g - 1; top >= 0; top -= 32 * kLook) {  // warp-uniform
      unsigned long long w[kLook];
#pragma unroll
      for (int i = 0; i < kLook; ++i) {
        const int j = top - lane - 32 * i;
        w[i] = j >= 0 ? load_word(&status[j]) : 0ull;
      }
#pragma unroll
      for (int i = 0; i < kLook; ++i) {
        const int j = top - lane - 32 * i;
        if (j >= 0 && w[i] == 0) w[i] = wait_word(&status[j]);
      }
      if (top == g - 1) {
        prev_last =
            (int)__shfl_sync(kFull, (unsigned)(w[0] >> 32) & 0x7fu, 0);
      }
      int stop = 32 * kLook;  // position of the nearest inclusive word
#pragma unroll
      for (int i = kLook - 1; i >= 0; --i) {
        const unsigned found = __ballot_sync(
            kFull, top - lane - 32 * i >= 0 && (w[i] & kInclusive) != 0);
        if (found) stop = 32 * i + __ffs(found) - 1;
      }
      unsigned sum = 0;  // < 2^31 + 127 * 32768 over the warp
      bool ov = false;
#pragma unroll
      for (int i = 0; i < kLook; ++i) {
        const int pos = lane + 32 * i;
        const bool mine = top - pos >= 0 && pos <= stop;
        sum += mine ? (unsigned)w[i] : 0u;
        ov |= mine && (w[i] & kOver) != 0;
      }
      excl += __reduce_add_sync(kFull, sum);
      over_before |= __any_sync(kFull, ov);
      if (stop < 32 * kLook) break;
    }
    if (lane == 0) {
      const bool over_all = over || over_before;
      if (g > 0) {
        store_word(&status[g], kInclusive | (unsigned)(excl + total) |
                                   (over_all ? kOver : 0ull) |
                                   (own & (0x7full << 32)));
      }
      if (g == groups - 1) F::header(out, excl + total, over_all);
      s_base = excl;
      s_prev_last = prev_last;
    }
  }
  __syncthreads();

  // 4: the words of each row, from the staged entries: a lane's first word
  // goes at the row's offset plus the starts of the lower lanes, and its
  // first delta reaches back to their last start (four ballots)
  const long long gbase = s_base;
  const unsigned lower = (1u << lane) - 1u;
  for (int k = 0; k < kRows; ++k) {
    const int i = warp * kRows + k;
    if (i >= in_group) break;  // warp-uniform
    const int cnt = s_cnt[i];
    const long long at0 = F::kHeader + gbase + s_off[i];
    if (cnt == 0 || cnt > F::kCap || at0 >= n_words) continue;
    const long long row = row0 + i;
    typename F::P v;
    const unsigned b = row_bits<F>(tile, x, i, row, lane, v);
    const RowBits r = row_ballots(b);
    int prev = 0;  // the start before the lane's first (delta formats)
    if constexpr (F::kForced) {
      // lane 0's first start is forced; it reaches back into the row
      // before (delta 0 for the table's first run)
      prev = lane > 0 ? row_last(r, lower)
                      : (row == 0 ? 0
                                  : (i == 0 ? s_prev_last
                                            : (int)s_last[i - 1]) - kForce);
    }
    const long long rbase = row * kForce;
    long long at = at0 + row_count(r, lower);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (b & (1u << j)) {
        const int pos = lane * 4 + j;
        if (at < n_words) out[at] = F::word(rbase, pos, prev, ent(v, j));
        ++at;
        prev = pos;
      }
    }
  }

  // 5: the block that finishes last leaves the scratch at 0
  __syncthreads();
  if (threadIdx.x == 0) {
    s_final = atomicAdd(&counters[1], 1u) == (unsigned)groups - 1;
  }
  __syncthreads();
  if (s_final) {
    for (int j = threadIdx.x; j < groups; j += kThreads) status[j] = 0;
    if (threadIdx.x == 0) {
      counters[0] = 0;
      counters[1] = 0;
    }
  }
}

// x: (rows * 128,) entries, 16-byte aligned; status: (ceil(rows / kGroup)
// + 1,) 64-bit words, 0; out: (n_words,) words.
template <class F>
int encode(const typename F::T* x, int rows, unsigned long long* status,
           typename F::W* out, long long n_words, cudaStream_t st) {
  if (rows < 1 || rows > (1 << 24) || n_words < F::kHeader ||
      status == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (F::kForced && n_words < F::kHeader + (long long)rows * F::kCap) {
    return (int)cudaErrorInvalidValue;
  }
  // all of an SM's shared memory for the blocks (the default carveout
  // leaves room for fewer of them)
  static int carved[PT_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= PT_MAX_DEVICES || !carved[dev]) {
    err = cudaFuncSetAttribute(rle_encode<F>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return (int)err;
    if (dev < PT_MAX_DEVICES) carved[dev] = 1;
  }
  const int groups = (rows + F::kGroup - 1) / F::kGroup;
  const int smem = F::kGroup * kForce * (int)sizeof(typename F::T);
  rle_encode<F><<<groups, kThreads, smem, st>>>(x, rows, groups, out,
                                                n_words, status);
  return (int)cudaGetLastError();
}

}  // namespace

// v2: out (n_words,) u16, n_words >= 3 + rows * 32.
PT_EXPORT int pt_rle_encode_u8_v2(const uint8_t* x, int rows, void* status,
                                  uint16_t* out, long long n_words,
                                  void* stream) {
  return encode<V2U8>(x, rows, (unsigned long long*)status, out, n_words,
                      (cudaStream_t)stream);
}

// v1: out (n_words,) u32; words past n_words are not written.
PT_EXPORT int pt_rle_encode_u8(const uint8_t* x, int rows, void* status,
                               uint32_t* out, long long n_words,
                               void* stream) {
  if ((long long)rows * kForce > (1LL << 24)) {  // pos << 8 in 32 bits
    return (int)cudaErrorInvalidValue;
  }
  return encode<V1U8>(x, rows, (unsigned long long*)status, out, n_words,
                      (cudaStream_t)stream);
}

// u16 v2: out (n_words,) u32, n_words >= 2 + rows * 32.
PT_EXPORT int pt_rle_encode_u16_v2(const uint16_t* x, int rows, void* status,
                                   uint32_t* out, long long n_words,
                                   void* stream) {
  return encode<V2U16>(x, rows, (unsigned long long*)status, out, n_words,
                       (cudaStream_t)stream);
}
