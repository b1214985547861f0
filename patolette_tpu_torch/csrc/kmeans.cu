// K4: one weighted Lloyd step.
//
// Replaces the loop body of patolette_tpu/models/kmeans.py::lloyd_iterations
// (assign -> one-hot segment matmul of [w, w x] -> centre update ->
// _split_empty). The JAX package ran it as three XLA programs a step; here
// it is three kernels in two entry points (the moments, then the update,
// so the multi-device route can sum the ranks' moments between them) and
// no host round trip, so a whole single-device KMeans run is enqueued
// without a sync.
//
// kmeans_partial: each sample's nearest centre (K3's arithmetic: skip
// invalid slots, strict <, |c|^2 - 2 ((xa ca + xb cb) + xc cc) with every
// op rounded on its own), then [w, w x0, w x1, w x2] accumulated into a
// per-block (P, 4) table by owner scans (no atomics); pt_sum_partials sums
// the tables in block order.
// kmeans_finalize: ONE block updates the
// centres (mean where the cluster has mass and the slot is valid) and walks
// the P slots in order as _split_empty does: a valid empty slot takes the
// valid cluster of largest mass (first index on ties), both move by
// +-1/1024 with alternating signs per coordinate, and the mass is halved.
//
// Bound on the H100: f32 operations of the assignment, 7 per (sample,
// centre): at M = 262,144, P = 256, 0.47 GFLOP a step, ~7 us at 67
// TFLOP/s; the bytes (3.1 MB of samples and weights) take ~1 us. The
// sequential split walk is latency, not throughput: it runs only for the
// slots that are empty, each a block-wide argmax.
//
// Any palette size: the centres pass through shared memory in tiles of
// kTile (a sample's running minimum carries across tiles, strict <, so the
// lowest index still wins ties), and a (P, 4) table that does not fit in
// shared memory (P > kSmemTable) is kept in the block's own slice of the
// partials in device memory, with the same owner scans. The finalize then
// reads the (P, 4) sums in device memory, keeps the (P,) masses in device
// scratch and updates the centres in place in the output.
#include "common.cuh"

namespace {

constexpr float kEps = 1.0f / 1024.0f;
constexpr int kFinalizeThreads = 1024;
constexpr int kTile = 2048;        // centres per shared-memory tile
constexpr int kSmemTable = 4096;   // largest P whose tables are shared

__device__ __forceinline__ void load_centres(float4* sc, int* sv,
                                             const float* __restrict__ c,
                                             const int* __restrict__ valid,
                                             int t0, int cnt) {
  for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
    const int g = t0 + k;
    const float c0 = c[3 * g], c1 = c[3 * g + 1], c2 = c[3 * g + 2];
    sc[k] = make_float4(c0, c1, c2, pt_norm2(c0, c1, c2));
    sv[k] = valid[g];
  }
}

// kShared: the (P, 4) table lives in shared memory (P <= kSmemTable); a
// template parameter, so the table's address space is known statically.
template <bool kShared>
__global__ void kmeans_partial(const float* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ centers,
                               const int* __restrict__ valid, int m, int p,
                               int per_block, float* __restrict__ partials,
                               int* __restrict__ labels) {
  extern __shared__ float4 smem4[];
  const int tile = min(p, kTile);
  const bool resident = p <= kTile;
  float4* sc = smem4;                                // tile
  int* sv = (int*)(sc + tile);                       // tile
  float* stage = (float*)(sv + ((tile + 3) & ~3));   // PT_STAGE * 4
  int* skey = (int*)(stage + PT_STAGE * 4);          // PT_STAGE
  float* table = kShared ? (float*)(skey + PT_STAGE)  // p * 4
                         : partials + (size_t)blockIdx.x * p * 4;

  const int tid = threadIdx.x;
  for (int i = tid; i < p * 4; i += blockDim.x) table[i] = 0.0f;
  if (resident) load_centres(sc, sv, centers, valid, 0, p);

  const int start = blockIdx.x * per_block;
  const int end = min(m, start + per_block);
  for (int base = start; base < end; base += PT_STAGE) {
    const int cnt = min(PT_STAGE, end - base);
    __syncthreads();
    // one staged sample per thread (blockDim == PT_STAGE)
    const int q = base + tid;
    const bool own = tid < cnt;
    float xa = 0.0f, xb = 0.0f, xc = 0.0f;
    if (own) {
      xa = x[3 * (size_t)q];
      xb = x[3 * (size_t)q + 1];
      xc = x[3 * (size_t)q + 2];
    }
    float best = INFINITY;
    int lbl = 0;
    for (int t0 = 0; t0 < p; t0 += tile) {
      const int tcnt = min(tile, p - t0);
      if (!resident) {
        __syncthreads();
        load_centres(sc, sv, centers, valid, t0, tcnt);
        __syncthreads();
      }
      if (own) {
        for (int k = 0; k < tcnt; ++k) {
          if (!sv[k]) continue;
          const float d = pt_dist(xa, xb, xc, sc[k]);
          if (d < best) {
            best = d;
            lbl = t0 + k;
          }
        }
      }
    }
    if (own) {
      const float wq = w ? w[q] : 1.0f;
      float* s = stage + tid * 4;
      s[0] = wq;
      s[1] = __fmul_rn(wq, xa);
      s[2] = __fmul_rn(wq, xb);
      s[3] = __fmul_rn(wq, xc);
      skey[tid] = lbl;
      if (labels) labels[q] = lbl;
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const int key = skey[i];
      if (key % PT_THREADS == tid) {
        float* row = table + (size_t)key * 4;
        const float* s = stage + i * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k) row[k] = __fadd_rn(row[k], s[k]);
      }
    }
  }
  if (kShared) {
    __syncthreads();
    float* dst = partials + (size_t)blockIdx.x * p * 4;
    for (int i = tid; i < p * 4; i += blockDim.x) dst[i] = table[i];
  }
}

// (v1, i1) <- better of itself and (v2, i2): larger value, then lower index;
// index p marks "no element".
__device__ __forceinline__ void argmax_merge(float& v1, int& i1, float v2,
                                             int i2, int p) {
  if (i2 == p) return;
  if (i1 == p || v2 > v1 || (v2 == v1 && i2 < i1)) {
    v1 = v2;
    i1 = i2;
  }
}

template <bool kShared>
__global__ void kmeans_finalize(const float* __restrict__ gmom,
                                const float* __restrict__ cin,
                                float* __restrict__ cout,
                                const int* __restrict__ valid, int p,
                                float* ghs) {
  __shared__ float red_v[kFinalizeThreads];
  __shared__ int red_i[kFinalizeThreads];
  extern __shared__ float fsm[];
  // (P, 4) sums, (P,) masses, (P, 3) centres and (P,) flags in shared
  // memory when they fit, else read from the sums in device memory, the
  // masses in device scratch and the centres in the output itself
  float* smom = fsm;                                          // p * 4
  float* hs = kShared ? smom + (size_t)p * 4 : ghs;           // p
  float* cent = kShared ? hs + p : cout;                      // p * 3
  const int* sv = kShared ? (const int*)(cent + (size_t)p * 3) : valid;
  const float* mom = kShared ? smom : gmom;

  const int tid = threadIdx.x;
  for (int i = tid; i < p * 3; i += blockDim.x) cent[i] = cin[i];
  if (kShared) {
    for (int i = tid; i < p * 4; i += blockDim.x) smom[i] = gmom[i];
    for (int k = tid; k < p; k += blockDim.x) ((int*)sv)[k] = valid[k];
  }
  __syncthreads();
  for (int k = tid; k < p; k += blockDim.x) {
    const float h = mom[4 * k];
    if (h > 0.0f && sv[k]) {
      for (int j = 0; j < 3; ++j) {
        cent[3 * k + j] = __fdiv_rn(mom[4 * k + 1 + j], h);
      }
    }
    hs[k] = sv[k] ? h : 1.0f;
  }
  __syncthreads();

  for (int ci = 0; ci < p; ++ci) {
    if (!(sv[ci] && hs[ci] == 0.0f)) continue;  // uniform across the block
    float bv = -INFINITY;
    int bi = p;
    for (int k = tid; k < p; k += blockDim.x) {
      argmax_merge(bv, bi, sv[k] ? hs[k] : -INFINITY, k, p);
    }
    red_v[tid] = bv;
    red_i[tid] = bi;
    __syncthreads();
    for (int off = blockDim.x / 2; off > 0; off >>= 1) {
      if (tid < off) {
        float v = red_v[tid];
        int i = red_i[tid];
        argmax_merge(v, i, red_v[tid + off], red_i[tid + off], p);
        red_v[tid] = v;
        red_i[tid] = i;
      }
      __syncthreads();
    }
    if (tid == 0) {
      const int cj = red_i[0] == p ? 0 : red_i[0];
      const float up[3] = {1.0f + kEps, 1.0f - kEps, 1.0f + kEps};
      const float dn[3] = {1.0f - kEps, 1.0f + kEps, 1.0f - kEps};
      float c[3];
      for (int j = 0; j < 3; ++j) c[j] = cent[3 * cj + j];
      for (int j = 0; j < 3; ++j) cent[3 * ci + j] = __fmul_rn(c[j], up[j]);
      for (int j = 0; j < 3; ++j) cent[3 * cj + j] = __fmul_rn(c[j], dn[j]);
      const float half = __fdiv_rn(hs[cj], 2.0f);
      hs[ci] = half;
      hs[cj] = __fadd_rn(hs[cj], -half);
    }
    __syncthreads();
  }
  if (kShared) {
    for (int i = tid; i < p * 3; i += blockDim.x) cout[i] = cent[i];
  }
}

template <bool kShared>
int kmeans_moments(const float* x, const float* w, const float* cin,
                   const int* valid, int m, int p, int per_block,
                   int nblocks, float* partials, int* labels, float* mom,
                   cudaStream_t st) {
  const int tile = p < kTile ? p : kTile;
  const size_t smem1 = (size_t)tile * 16 + (size_t)((tile + 3) & ~3) * 4 +
                       PT_STAGE * 16 + PT_STAGE * 4 +
                       (kShared ? (size_t)p * 16 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kmeans_partial<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  kmeans_partial<kShared><<<nblocks, PT_THREADS, smem1, st>>>(
      x, w, cin, valid, m, p, per_block, partials, labels);
  const int len = p * 4;
  pt_sum_partials<<<(len + 255) / 256, 256, 0, st>>>(partials, nblocks, len,
                                                      mom);
  return (int)cudaGetLastError();
}

template <bool kShared>
int kmeans_update(const float* mom, const float* cin, const int* valid,
                  int p, float* cout, float* ghs, cudaStream_t st) {
  const size_t smem2 = kShared ? (size_t)p * (4 + 1 + 3 + 1) * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kmeans_finalize<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem2);
  if (err != cudaSuccess) return (int)err;
  kmeans_finalize<kShared><<<1, kFinalizeThreads, smem2, st>>>(
      mom, cin, cout, valid, p, ghs);
  return (int)cudaGetLastError();
}

}  // namespace

// The step's first half: labels (optional) and the (P, 4) [w, w x] sums of
// this device's samples into mom.
PT_EXPORT int pt_kmeans_moments(const float* x, const float* w,
                                 const float* cin, const int* valid, int m,
                                 int p, int per_block, int nblocks,
                                 float* partials, int* labels, float* mom,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (p <= kSmemTable) {
    return kmeans_moments<true>(x, w, cin, valid, m, p, per_block, nblocks,
                                partials, labels, mom, st);
  }
  return kmeans_moments<false>(x, w, cin, valid, m, p, per_block, nblocks,
                               partials, labels, mom, st);
}

// The step's second half: centre update and empty-cluster split from the
// (P, 4) sums mom (this device's, or every rank's), cin -> cout; ghs (P,)
// scratch when P > kSmemTable.
PT_EXPORT int pt_kmeans_update(const float* mom, const float* cin,
                               const int* valid, int p, float* cout,
                               float* ghs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (p <= kSmemTable) {
    return kmeans_update<true>(mom, cin, valid, p, cout, ghs, st);
  }
  return kmeans_update<false>(mom, cin, valid, p, cout, ghs, st);
}
