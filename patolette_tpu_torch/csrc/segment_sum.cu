// K1: segment sum. feats (N, F) f32 and ids (N,) int32 -> out (S, F) f32.
//
// Replaces patolette_tpu/ops/moments.py::segment_matmul (the chunked one-hot
// matmul behind segment_moments, palette.centers_from_labels and the LQ
// mean/moment passes). On the TPU the sum was a one-hot matmul on the MXU
// because scatter is slow there; on Hopper it is a histogram.
//
// Bound on the H100: device-memory bytes. Each pixel is read once (4F + 4
// bytes) and does F adds, so at N = 2^18, F = 11 the floor is ~13 MB, a few
// microseconds at 3.35 TB/s. What costs more is making the sum
// deterministic without atomics, and the launches.
//
// Design (warp-grouped accumulation, common.cuh): a grid of a small
// multiple of the SM count; block b's warp w walks its own contiguous range
// of per_warp pixels, 32 a step: the step's feature rows are staged in the
// warp's shared-memory slot (coalesced), ids outside the segment tile are
// dropped, __match_any_sync groups the lanes by id and each group's sum (in
// ascending lane order) is added to the warp's own (tile, F) table. The
// block sums its warps' tables in warp order into its partial. The blocks'
// partials are summed in groups of PT_GROUP consecutive blocks (block
// order), then the groups in group order: in the same launch by the last
// block to finish (fused, one launch: the LQ loop's S = 12 and 16 and the
// palette's 256 x 4), or by pt_sum_groups as a second launch (S x F above
// the wrapper's threshold, GQ's 512 x 11). So out[s][k] = sum over groups,
// in order, of sum over the group's blocks, in order, of sum over warps, in
// order, of the warp's steps in pixel order, each a group sum in lane
// order.
//
// Eight tables of S x F floats fit in PT_SMEM_MAX up to S x F ~ 6000 (GQ's
// 512 x 11 takes 180 KB: one block an SM). Above that the segments are
// split into tiles over gridDim.y, each tile rereading the pixels (the
// adversarial S = 4096 x 11 takes 8); tiles are never fused.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
int g_smem_done[PT_MAX_DEVICES];

// Lane's share of the step at base: row elements lane + 32 q (q < f) of
// the step's rows into next[q], and pixel base + lane's id.
__device__ __forceinline__ void load_step(const float* __restrict__ feats,
                                          const int* __restrict__ ids, int f,
                                          long long base, long long end,
                                          int lane, float (&next)[32],
                                          int& next_id) {
  const int len = (int)min(32LL, end - base) * f;
  const float* src = feats + base * f;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    if (q < f && lane + 32 * q < len) next[q] = src[lane + 32 * q];
  }
  if (base + lane < end) next_id = ids[base + lane];
}

__global__ void __launch_bounds__(kThreads)
    segment_accumulate(const float* __restrict__ feats,
                       const int* __restrict__ ids, int n, int f, int s,
                       int tile, int per_warp, int fused,
                       float* __restrict__ partials, unsigned* counters,
                       float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s0 = blockIdx.y * tile;
  const int slots = min(tile, s - s0);
  const int tlen = slots * f;
  float* tables = smem;                               // kWarps * tlen
  float* stage = tables + (size_t)kWarps * tlen;      // kWarps * 32 * f
  int* order = (int*)(stage + (size_t)kWarps * 32 * f);  // kWarps * 96
  float* mytab = tables + (size_t)warp * tlen;
  float* mystage = stage + (size_t)warp * 32 * f;
  int* myorder = order + warp * 96;
  for (int i = threadIdx.x; i < kWarps * tlen; i += kThreads) tables[i] = 0.0f;
  __syncthreads();

  const long long start = ((long long)blockIdx.x * kWarps + warp) * per_warp;
  const long long end = min((long long)n, start + per_warp);
  // The next step's ids and rows are loaded into registers (row element
  // lane + 32 q in next[q], q < f) while this step accumulates.
  float next[32];
  int next_id = 0;
  if (start < end) load_step(feats, ids, f, start, end, lane, next, next_id);
  for (long long base = start; base < end; base += 32) {
    const int len = (int)min(32LL, end - base) * f;
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      if (q < f && lane + 32 * q < len) mystage[lane + 32 * q] = next[q];
    }
    int key = -1;
    if (base + lane < end) {
      const unsigned rel = (unsigned)next_id - (unsigned)s0;
      key = rel < (unsigned)slots ? (int)rel : -1;
    }
    __syncwarp();
    if (base + 32 < end) {
      load_step(feats, ids, f, base + 32, end, lane, next, next_id);
    }
    pt_warp_accumulate(key, mystage, f, mytab, myorder);
    __syncwarp();
  }
  __syncthreads();

  float* dst = partials + ((size_t)blockIdx.x * s + s0) * f;
  for (int i = threadIdx.x; i < tlen; i += kThreads) {
    float acc = tables[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      acc = __fadd_rn(acc, tables[(size_t)w * tlen + i]);
    }
    dst[i] = acc;
  }
  if (fused) pt_finish_partials(partials, s * f, out, counters);
}

}  // namespace

// partials: (nblocks, S, F) scratch; counters: nblocks / PT_GROUP + 2 ints,
// zero (and left zero); out: (S, F). per_warp: pixels of a warp's range, a
// multiple of 32, with nblocks * 8 * per_warp >= n. fused: sum the
// partials in this launch (ignored when the segments need tiles).
PT_EXPORT int pt_segment_sum(const float* feats, const int* ids, int n, int f,
                             int s, int per_warp, int nblocks, int fused,
                             float* partials, unsigned* counters, float* out,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (f < 1 || f > 32 || nblocks < 1 || nblocks > PT_GROUP * PT_MAX_GROUPS) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t stage_bytes = (size_t)kWarps * (32 * f + 96) * 4;
  size_t tile = (PT_SMEM_MAX - stage_bytes) / ((size_t)kWarps * f * 4);
  if (tile > (size_t)s) tile = s;
  const int ntiles = (int)((s + tile - 1) / tile);
  const size_t smem = (size_t)kWarps * tile * f * 4 + stage_bytes;
  cudaError_t err = pt_opt_in_smem(segment_accumulate, PT_SMEM_MAX,
                                   g_smem_done);
  if (err != cudaSuccess) return (int)err;
  const int fuse = fused && ntiles == 1;
  segment_accumulate<<<dim3(nblocks, ntiles), kThreads, smem, st>>>(
      feats, ids, n, f, s, (int)tile, per_warp, fuse, partials, counters,
      out);
  if (!fuse) {
    const int len = s * f;
    pt_sum_groups<<<(len + 31) / 32, PT_THREADS, 0, st>>>(partials, nblocks,
                                                          len, out);
  }
  return (int)cudaGetLastError();
}
