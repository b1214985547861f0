// K2: the per-pixel pass of the LQ candidate evaluation.
//
// Replaces the per-pixel part of
// patolette_tpu/models/local_q.py::_candidates_segmented (passes 3 and 4:
// projection on each candidate's own axis, linear binning over +-4 sigma
// and the per-(candidate, bucket) sums of [w, w x', w |x'|^2]). The JAX
// package spread the candidate axis over matmul feature lanes to feed a
// (N, 512) one-hot product on the MXU; here it is a fused histogram pass.
//
// Inputs: colors (N, 3), member weights wm (N,) (0 off the candidates),
// cand (N,) int32 (the pixel's candidate slot, C for none) and a (C, 8)
// table per candidate: mean (3), axis (3), pmin, 1/(pmax - pmin) (0 for a
// flat cluster). Membership is resolved once a round, before the mean and
// moment passes (K1) that need it too, by one gather of the pixel's label
// through a (P + 1)-entry slot table; this pass reads the result. Outputs:
// the (C, nb, 5) table and the bucket of every pixel (0 off the
// candidates), from which the caller derives the side bit
// (bucket <= cut of the pixel's candidate).
//
// Arithmetic, op for op the plain version's: x' = c - mu; proj =
// (x'0 a0 + x'1 a1) + x'2 a2; bucket = clamp(trunc((proj - pmin) * scale *
// nb), 0, nb - 1); features rounded to bf16 (round to nearest even) and
// summed in f32, as the JAX package's bf16 one-hot product does.
//
// Bound on the H100: bytes. Every pixel's cand read and bucket written
// (8 B), a member's colour and weight read (16 B), the table written:
// ~6 MB at N = 2^18 when nearly every pixel is a member, under 2 us; ~2.7
// MB (under 1 us) at the LQ loop's typical share of 0.11. The table is C
// x 512 x 5 f32 = 160 KB at C = 16.
//
// Design (key-grouped accumulation, common.cuh): the key of a member is
// its bucket within its candidate. A block owns one candidate (blockIdx.y)
// and each of its 8 warps holds that candidate's (nb, 5) table in shared
// memory (10 KB at nb = 512, two blocks an SM); a block's warp w walks its
// own contiguous range of pixels, kBatch steps of 32 at a time (the ids of
// the batch loaded at once, then the colours and weights of the lanes of
// the block's candidate), computes the buckets and bf16 features of its
// lanes, and pt_warp_accumulate groups the lanes by bucket
// (__match_any_sync) and adds each group's sum, in ascending lane order,
// to the warp's own table. A pixel with no candidate has its bucket set to
// 0 by the blocks of candidate 0 and does nothing else. The block sums its
// warps' tables in warp order into its partial, and pt_finish_partials
// sums the candidate's partials in block groups in the same launch
// (integer tickets): one launch a call, no float atomics, every sum in an
// order fixed by the code.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kF = 5;      // features a member adds
constexpr int kBatch = 8;  // steps of 32 pixels whose ids load at once
int g_smem_done[PT_MAX_DEVICES];

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads)
    lq_accumulate(const float* __restrict__ colors,
                  const float* __restrict__ wm, const int* __restrict__ cand,
                  const float* __restrict__ tab, int n, int c, int nb,
                  int per_warp, float* __restrict__ partials,
                  unsigned* counters, float* __restrict__ out,
                  int* __restrict__ bucket) {
  extern __shared__ float smem[];
  __shared__ float t[8];  // the block's candidate's row of the table
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cy = blockIdx.y;
  const int tlen = nb * kF;
  float* tables = smem;                               // kWarps * tlen
  float* stage = tables + (size_t)kWarps * tlen;      // kWarps * 32 * kF
  int* order = (int*)(stage + kWarps * 32 * kF);      // kWarps * 96
  float* mytab = tables + (size_t)warp * tlen;
  float* mystage = stage + warp * 32 * kF;
  int* myorder = order + warp * 96;
  for (int i = threadIdx.x; i < kWarps * tlen; i += kThreads) tables[i] = 0;
  if (threadIdx.x < 8) t[threadIdx.x] = tab[cy * 8 + threadIdx.x];
  __syncthreads();

  const float fnb = (float)nb;
  const float top = (float)(nb - 1);
  const long long start = ((long long)blockIdx.x * kWarps + warp) * per_warp;
  const long long end = min((long long)n, start + per_warp);
  for (long long base = start; base < end; base += 32 * kBatch) {
    int cd[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long q = base + 32 * j + lane;
      cd[j] = q < end ? cand[q] : -1;
    }
    float px[kBatch][3], pw[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (cd[j] == cy) {
        const long long q = base + 32 * j + lane;
        px[j][0] = colors[3 * q];
        px[j][1] = colors[3 * q + 1];
        px[j][2] = colors[3 * q + 2];
        pw[j] = wm[q];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long q = base + 32 * j + lane;
      int key = -1;
      if (cd[j] == cy) {
        const float x0 = __fsub_rn(px[j][0], t[0]);
        const float x1 = __fsub_rn(px[j][1], t[1]);
        const float x2 = __fsub_rn(px[j][2], t[2]);
        const float proj = __fadd_rn(
            __fadd_rn(__fmul_rn(x0, t[3]), __fmul_rn(x1, t[4])),
            __fmul_rn(x2, t[5]));
        const float ratio = __fmul_rn(__fsub_rn(proj, t[6]), t[7]);
        // fmaxf maps NaN to 0; the clamp makes the conversion defined.
        const float v = fminf(fmaxf(__fmul_rn(ratio, fnb), 0.0f), top);
        key = (int)v;
        bucket[q] = key;
        const float w = pw[j];
        const float wx0 = __fmul_rn(w, x0);
        const float wx1 = __fmul_rn(w, x1);
        const float wx2 = __fmul_rn(w, x2);
        const float w2 = __fadd_rn(
            __fadd_rn(__fmul_rn(wx0, x0), __fmul_rn(wx1, x1)),
            __fmul_rn(wx2, x2));
        float* s = mystage + lane * kF;
        s[0] = bf16_round(w);
        s[1] = bf16_round(wx0);
        s[2] = bf16_round(wx1);
        s[3] = bf16_round(wx2);
        s[4] = bf16_round(w2);
      } else if (cy == 0 && q < end && (cd[j] < 0 || cd[j] >= c)) {
        bucket[q] = 0;
      }
      if (__any_sync(PT_FULL, key >= 0)) {
        __syncwarp();
        pt_warp_accumulate(key, mystage, kF, mytab, myorder);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // the candidate's partials: one row of tlen floats a block, in block order
  float* rows = partials + (size_t)cy * gridDim.x * tlen;
  float* dst = rows + (size_t)blockIdx.x * tlen;
  for (int i = threadIdx.x; i < tlen; i += kThreads) {
    float acc = tables[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      acc = __fadd_rn(acc, tables[(size_t)w * tlen + i]);
    }
    dst[i] = acc;
  }
  const int ngroups = (gridDim.x + PT_GROUP - 1) / PT_GROUP;
  pt_finish_partials(rows, tlen, out + (size_t)cy * tlen,
                     counters + cy * (ngroups + 1));
}

// Dynamic shared memory of a block at this bucket count: eight (nb, 5)
// tables, the staged rows and the group lists.
int smem_bytes(int nb) {
  return kWarps * (nb * kF + 32 * kF + 96) * (int)sizeof(float);
}

}  // namespace

// per_warp: pixels of a warp's range; nblocks: blocks a candidate,
// nblocks * 8 * per_warp >= n. partials: C * nblocks * nb * 5 floats of
// scratch; counters: C * (nblocks / PT_GROUP + 2) ints, zero (and left
// zero); out: (C, nb, 5); bucket: (N,).
PT_EXPORT int pt_lq_candidates(const float* colors, const float* wm,
                               const int* cand, const float* tab, int n,
                               int c, int nb, int per_warp, int nblocks,
                               float* partials, unsigned* counters,
                               float* out, int* bucket, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = smem_bytes(nb);
  if (c < 1 || nb < 1 || smem > PT_SMEM_MAX || nblocks < 1 ||
      nblocks > PT_GROUP * PT_MAX_GROUPS) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = pt_opt_in_smem(lq_accumulate, PT_SMEM_MAX, g_smem_done);
  if (err != cudaSuccess) return (int)err;
  lq_accumulate<<<dim3(nblocks, c), kThreads, smem, st>>>(
      colors, wm, cand, tab, n, c, nb, per_warp, partials, counters, out,
      bucket);
  return (int)cudaGetLastError();
}
