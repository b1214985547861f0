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
// and a level is a minimum over up to 512 candidates (~0.45 us). The
// design is the simple one: one block, a thread a column n, the prefix in
// shared memory, a barrier between levels. D(t, n) is recomputed from the
// prefix at every level (never stored as a (b+1)^2 matrix). The thread of
// the last column walks 512 candidates a level, each a dependent chain of
// ~40 instructions (the IEEE division among them), so the block waits on
// that one thread's latency at each of the 11 levels: a column spread
// over a warp, or a level over SMs, would cut it.
//
// Bits: every operation is rounded on its own (no FMA contraction), in the
// plain version's order (kernels/gq.py::gq_dp_plain): the prefix summed
// row by row; s = (dx dx + dy dy) + dz dz; d = dw2 - s / dw0; D = d where
// dw0 > 0 (then 0 below 0, NaN kept), else 0; the candidate cost
// E_{k-1}[t] + D(t, n). The minimum follows jnp.min and the argmin of the
// reversed row: a NaN candidate wins (the largest t among NaNs), else the
// smallest cost, ties to the largest t; a column with no finite candidate
// has cost +inf and cut b.
#include "common.cuh"

namespace {

constexpr int kMaxK = 12;
constexpr int kMoments = 11;

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

// One block. Shared memory: the prefix (b+1, 11), two level rows of
// (b+1) floats, and the cut rows (k_max+1, b+1) as int16.
__global__ void gq_dp_kernel(const float* __restrict__ bm, int b, int k_max,
                             float* __restrict__ prefix_out,
                             float* __restrict__ cost_out,
                             int* __restrict__ cut_out,
                             int* __restrict__ chains_out) {
  extern __shared__ float smem[];
  const int cols = b + 1;
  float* prefix = smem;
  float* e_prev = prefix + cols * kMoments;
  float* e_next = e_prev + cols;
  short* cuts = reinterpret_cast<short*>(e_next + cols);
  const int tid = threadIdx.x;

  // The bucket moments into rows 1..b, row 0 zero; then each of the 11
  // columns summed in row order by one thread.
  for (int i = tid; i < cols * kMoments; i += blockDim.x) {
    prefix[i] = i < kMoments ? 0.0f : bm[i - kMoments];
  }
  __syncthreads();
  if (tid < kMoments) {
    float acc = 0.0f;
#pragma unroll 8
    for (int r = 1; r < cols; ++r) {
      acc = __fadd_rn(acc, prefix[r * kMoments + tid]);
      prefix[r * kMoments + tid] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < cols * kMoments; i += blockDim.x) {
    prefix_out[i] = prefix[i];
  }

  const int n = tid;
  const bool col = n < cols;
  float w0n = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f, w2n = 0.0f;
  if (col) {
    const float* pn = prefix + n * kMoments;
    w0n = pn[0];
    ax = pn[1];
    ay = pn[2];
    az = pn[3];
    w2n = pn[4];
    // level 1: one cell (0, n]
    const float e1 = cell_d(prefix, w0n, ax, ay, az, w2n);
    e_prev[n] = e1;
    cost_out[n] = e1;
    cuts[n] = 0;
    cuts[cols + n] = 0;
  }
  __syncthreads();

  for (int k = 2; k <= k_max; ++k) {
    if (col) {
      float best = __int_as_float(0x7f800000);  // +inf
      int arg = b;
      bool nan_seen = false;
      for (int t = n - 1; t >= k - 1; --t) {
        const float c = __fadd_rn(
            e_prev[t], cell_d(prefix + t * kMoments, w0n, ax, ay, az, w2n));
        const bool cn = isnan(c);
        const bool take = !nan_seen && (cn || c < best);
        best = take ? c : best;
        arg = take ? t : arg;
        nan_seen = nan_seen || cn;
      }
      e_next[n] = best;
      cost_out[(k - 1) * cols + n] = best;
      cuts[k * cols + n] = (short)arg;
    }
    __syncthreads();
    float* swap = e_prev;
    e_prev = e_next;
    e_next = swap;
  }

  for (int i = tid; i < (k_max + 1) * cols; i += blockDim.x) {
    cut_out[i] = cuts[i];
  }
  // Level k's chain [0, q1, .., q_{k-1}, b, b, ..]: t walks down from b
  // through the cut rows k, k-1, .., 2.
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

size_t smem_bytes(int b, int k_max) {
  const size_t cols = (size_t)b + 1;
  return cols * kMoments * 4 + 2 * cols * 4 + (size_t)(k_max + 1) * cols * 2;
}

int g_smem_done[PT_MAX_DEVICES];

}  // namespace

// bm: (b, 11) f32 bucket moments. Outputs: prefix (b+1, 11) f32; cost
// (k_max, b+1) f32, row k-1 = E_k; cut (k_max+1, b+1) int32, rows 0 and 1
// zero, row k the cut row of level k; chains (k_max, 13) int32, row k-1
// the chain of level k. 1 <= k_max <= 12, b + 1 <= 1024.
PT_EXPORT int pt_gq_dp(const float* bm, int b, int k_max, float* prefix,
                       float* cost, int* cut, int* chains, void* stream) {
  if (b < 1 || b + 1 > 1024 || k_max < 1 || k_max > kMaxK) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(b, k_max);
  cudaError_t err = pt_opt_in_smem(gq_dp_kernel, (int)smem, g_smem_done);
  if (err != cudaSuccess) return (int)err;
  const int threads = ((b + 1 + 31) / 32) * 32;
  gq_dp_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      bm, b, k_max, prefix, cost, cut, chains);
  return (int)cudaGetLastError();
}
