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
// deterministic without atomics.
//
// Design: grid (blocks over pixel ranges, tiles over segments). A block
// stages PT_STAGE pixels (ids and feature rows, coalesced) in shared memory,
// then every thread walks the staged pixels in order and adds the rows of
// the segments it owns (segment % PT_THREADS == thread) into a shared
// (tile, F) table: one writer per slot, so no atomics and a fixed order.
// Each block writes its table to its own partial; pt_sum_partials adds the
// partials in block order. A segment tile keeps the table within 40 KB of
// shared memory (S = 512, F = 11 fits in one tile).
#include "common.cuh"

namespace {

constexpr int kTableBytes = 40 * 1024;

__global__ void segment_partial(const float* __restrict__ feats,
                                const int* __restrict__ ids, int n, int f,
                                int s, int tile, int per_block,
                                float* __restrict__ partials) {
  extern __shared__ float smem[];
  float* table = smem;                         // tile * f
  float* stage = table + (size_t)tile * f;     // PT_STAGE * f
  int* stage_ids = (int*)(stage + PT_STAGE * f);

  const int tid = threadIdx.x;
  const int s0 = blockIdx.y * tile;
  const int slots = min(tile, s - s0);
  for (int i = tid; i < slots * f; i += blockDim.x) table[i] = 0.0f;

  const int start = blockIdx.x * per_block;
  const int end = min(n, start + per_block);
  for (int base = start; base < end; base += PT_STAGE) {
    const int cnt = min(PT_STAGE, end - base);
    __syncthreads();
    const float* src = feats + (size_t)base * f;
    for (int i = tid; i < cnt * f; i += blockDim.x) stage[i] = src[i];
    for (int i = tid; i < cnt; i += blockDim.x) stage_ids[i] = ids[base + i];
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const int local = stage_ids[i] - s0;
      if (local >= 0 && local < slots && local % PT_THREADS == tid) {
        float* row = table + (size_t)local * f;
        const float* x = stage + i * f;
        for (int k = 0; k < f; ++k) row[k] = __fadd_rn(row[k], x[k]);
      }
    }
  }
  __syncthreads();
  float* dst = partials + ((size_t)blockIdx.x * s + s0) * f;
  for (int i = tid; i < slots * f; i += blockDim.x) dst[i] = table[i];
}

}  // namespace

// partials: (nblocks, S, F) scratch; out: (S, F).
PT_EXPORT int pt_segment_sum(const float* feats, const int* ids, int n, int f,
                             int s, int per_block, int nblocks,
                             float* partials, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int stage_bytes = PT_STAGE * (f + 1) * 4;
  int tile = (kTableBytes - stage_bytes) / (f * 4);
  if (tile < 1) tile = 1;
  if (tile > s) tile = s;
  const int ntiles = (s + tile - 1) / tile;
  const size_t smem = (size_t)tile * f * 4 + stage_bytes;
  dim3 grid(nblocks, ntiles);
  segment_partial<<<grid, PT_THREADS, smem, st>>>(feats, ids, n, f, s, tile,
                                                  per_block, partials);
  const int len = s * f;
  pt_sum_partials<<<(len + 255) / 256, 256, 0, st>>>(partials, nblocks, len,
                                                     out);
  return (int)cudaGetLastError();
}
