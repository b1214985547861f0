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
// Bound on the H100: bytes. One read of colors, weights and cand (20 B a
// pixel) and one bucket write (4 B): ~6 MB at N = 2^18, under 2 us. The
// table is C x 512 x 5 f32 = 160 KB at C = 16.
//
// Design: grid (blocks over pixel ranges, tiles over candidates). The
// tile's table lives in dynamic shared memory (up to ~200 KB, so 19
// candidates a tile at nb = 512); a block computes the features of
// PT_STAGE pixels at a time into shared memory, then each thread adds the
// staged pixels whose (candidate, bucket) slot it owns, in pixel order: no
// atomics. Per-block partial tables are summed in block order by
// pt_sum_partials.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kSmemBudget = 200 * 1024;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void lq_partial(const float* __restrict__ colors,
                           const float* __restrict__ wm,
                           const int* __restrict__ cand,
                           const float* __restrict__ tab, int n, int c,
                           int nb, int ct, int per_block,
                           float* __restrict__ partials,
                           int* __restrict__ bucket) {
  extern __shared__ float smem[];
  float* table = smem;                                  // ct * nb * 5
  float* stage = table + (size_t)ct * nb * 5;           // PT_STAGE * 5
  int* stage_key = (int*)(stage + PT_STAGE * 5);        // PT_STAGE
  float* stab = (float*)(stage_key + PT_STAGE);         // ct * 8

  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * ct;
  const int nc = min(ct, c - c0);
  for (int i = tid; i < nc * nb * 5; i += blockDim.x) table[i] = 0.0f;
  for (int i = tid; i < nc * 8; i += blockDim.x) stab[i] = tab[c0 * 8 + i];

  const float fnb = (float)nb;
  const float top = (float)(nb - 1);
  const int start = blockIdx.x * per_block;
  const int end = min(n, start + per_block);
  for (int base = start; base < end; base += PT_STAGE) {
    const int cnt = min(PT_STAGE, end - base);
    __syncthreads();
    for (int i = tid; i < cnt; i += blockDim.x) {
      const int q = base + i;
      const int cd = cand[q];
      const int local = cd - c0;
      int key = -1;
      if (local >= 0 && local < nc) {
        const float* t = stab + local * 8;
        const float x0 = __fsub_rn(colors[3 * (size_t)q], t[0]);
        const float x1 = __fsub_rn(colors[3 * (size_t)q + 1], t[1]);
        const float x2 = __fsub_rn(colors[3 * (size_t)q + 2], t[2]);
        const float proj = __fadd_rn(
            __fadd_rn(__fmul_rn(x0, t[3]), __fmul_rn(x1, t[4])),
            __fmul_rn(x2, t[5]));
        const float ratio = __fmul_rn(__fsub_rn(proj, t[6]), t[7]);
        // fmaxf maps NaN to 0; the clamp makes the conversion defined.
        const float v = fminf(fmaxf(__fmul_rn(ratio, fnb), 0.0f), top);
        const int b = (int)v;
        bucket[q] = b;
        const float w = wm[q];
        const float wx0 = __fmul_rn(w, x0);
        const float wx1 = __fmul_rn(w, x1);
        const float wx2 = __fmul_rn(w, x2);
        const float w2 = __fadd_rn(
            __fadd_rn(__fmul_rn(wx0, x0), __fmul_rn(wx1, x1)),
            __fmul_rn(wx2, x2));
        float* s = stage + i * 5;
        s[0] = bf16_round(w);
        s[1] = bf16_round(wx0);
        s[2] = bf16_round(wx1);
        s[3] = bf16_round(wx2);
        s[4] = bf16_round(w2);
        key = local * nb + b;
      } else if (blockIdx.y == 0 && (cd < 0 || cd >= c)) {
        bucket[q] = 0;
      }
      stage_key[i] = key;
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const int key = stage_key[i];
      if (key >= 0 && key % PT_THREADS == tid) {
        float* row = table + (size_t)key * 5;
        const float* x = stage + i * 5;
#pragma unroll
        for (int k = 0; k < 5; ++k) row[k] = __fadd_rn(row[k], x[k]);
      }
    }
  }
  __syncthreads();
  float* dst = partials + ((size_t)blockIdx.x * c + c0) * nb * 5;
  for (int i = tid; i < nc * nb * 5; i += blockDim.x) dst[i] = table[i];
}

}  // namespace

// partials: (nblocks, C, nb, 5) scratch; out: (C, nb, 5); bucket: (N,).
PT_EXPORT int pt_lq_candidates(const float* colors, const float* wm,
                               const int* cand, const float* tab, int n,
                               int c, int nb, int per_block, int nblocks,
                               float* partials, float* out, int* bucket,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int fixed = PT_STAGE * 6 * 4;
  int ct = (kSmemBudget - fixed) / (nb * 5 * 4 + 8 * 4);
  if (ct < 1) return (int)cudaErrorInvalidValue;
  if (ct > c) ct = c;
  const int ntiles = (c + ct - 1) / ct;
  const size_t smem = (size_t)ct * nb * 5 * 4 + fixed + (size_t)ct * 8 * 4;
  cudaError_t err = cudaFuncSetAttribute(
      lq_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nblocks, ntiles);
  lq_partial<<<grid, PT_THREADS, smem, st>>>(colors, wm, cand, tab, n, c, nb,
                                             ct, per_block, partials, bucket);
  const int len = c * nb * 5;
  pt_sum_partials<<<(len + 255) / 256, 256, 0, st>>>(partials, nblocks, len,
                                                     out);
  return (int)cudaGetLastError();
}
