// Shared helpers of the port's kernels.
//
// Determinism rule of every kernel here: no float atomics, in global or in
// shared memory. Every float sum has an order fixed by the code, not by
// scheduling, so the same inputs give the same bits on every run. The
// per-block partial sums come from warp-grouped accumulation (K1, K2,
// K4): each warp owns a table in shared memory and walks its own
// contiguous range of pixels 32 at a time; __match_any_sync groups the
// lanes of a step by key, each group is summed in ascending lane order and
// added to the warp's table by one lane per column (pt_warp_accumulate).
// The block sums its warps' tables in warp order; the blocks' partials are
// summed in groups of PT_GROUP consecutive blocks, each group in block
// order, then the groups in group order (pt_finish_partials in the same
// launch, or pt_sum_groups as a second one: both give the same bits).
// Integer atomics appear only as tickets (which block finishes last, which
// band starts next), whose results do not depend on the order in which
// they are taken.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

// Threads of an accumulating block.
constexpr int PT_THREADS = 256;
constexpr unsigned PT_FULL = 0xffffffffu;
// Blocks whose partials are summed together before the groups are.
constexpr int PT_GROUP = 16;
// Most groups a grid may have (so at most PT_GROUP * PT_MAX_GROUPS blocks).
constexpr int PT_MAX_GROUPS = 64;
// Dynamic shared memory a kernel may opt into (of the H100's 227 KB).
constexpr int PT_SMEM_MAX = 200 * 1024;

// Each source is compiled on its own and linked into one library, so the
// helpers below have internal linkage.
namespace {

// d = |c|^2 - 2 (x . c), each op rounded on its own (no FMA contraction),
// in the order of the JAX package's planar assignment: (xa*ca + xb*cb) +
// xc*cc.
__device__ __forceinline__ float pt_dist(float xa, float xb, float xc,
                                         float4 c) {
  float dot = __fadd_rn(__fadd_rn(__fmul_rn(xa, c.x), __fmul_rn(xb, c.y)),
                        __fmul_rn(xc, c.z));
  return __fsub_rn(c.w, __fmul_rn(2.0f, dot));
}

// |c|^2 as (c0*c0 + c1*c1) + c2*c2.
__device__ __forceinline__ float pt_norm2(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

// True when every coordinate is at most 2^60 in magnitude (so not NaN or
// infinite). Between such a point and such a centre no operation of
// pt_dist or pt_norm2 overflows (products <= 2^120, |c|^2 <= 3 2^120, the
// doubled dot < 2^123), so the distance is finite (+inf only from an
// invalid slot's +inf |c|^2) and never NaN: a strict < then is argmin's
// rule, which otherwise takes the first NaN (K4 and K8 test this and take
// a NaN-rule path where it fails).
__device__ __forceinline__ bool pt_tame(float a, float b, float c) {
  constexpr float kBig = 1.152921504606846976e18f;  // 2^60
  return fabsf(a) <= kBig && fabsf(b) <= kBig && fabsf(c) <= kBig;
}

// (v, i) <- (ov, oi) when it comes first under argmin's rule: a NaN first
// (the lower index among NaNs), then the smaller value, then the lower
// index.
__device__ __forceinline__ void pt_take_min_nan(float& v, int& i, float ov,
                                                int oi) {
  const bool vn = isnan(v), on = isnan(ov);
  const bool t = on ? (!vn || oi < i)
                    : (!vn && (ov < v || (ov == v && oi < i)));
  v = t ? ov : v;
  i = t ? oi : i;
}

// One step of a warp's accumulation. Lane l holds `key`, the table row of
// the step's pixel l (-1: dropped, as is every lane past the range's end),
// and the pixel's f features at rows[l * f .. l * f + f) (the warp's own
// staging area in shared memory). Lanes that hold the same key form one
// group; each group's features are summed in ascending lane order and the
// sum is added to table[key * f ..] (this warp's own table: nobody else
// writes it). A lane alone in its group adds its own row. The groups of
// two or more are listed in `order` (the warp's 3 x 32 ints: lowest lane,
// lanes, key) in the order of their lowest lanes, and 32 / f of them are
// served at a time: lane sub * f + k sums column k of the groups sub, sub
// + 32 / f, ... Groups have distinct keys, so no two lanes write one slot
// at once. f <= 32.
__device__ __forceinline__ void pt_warp_accumulate(int key,
                                                   const float* rows, int f,
                                                   float* table, int* order) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const unsigned peers = __match_any_sync(PT_FULL, key);
  const bool alone = key >= 0 && peers == (1u << lane);
  if (alone) {
    const float* __restrict__ src = rows + lane * f;
    float* __restrict__ dst = table + (size_t)key * f;
#pragma unroll 4
    for (int k = 0; k < f; ++k) dst[k] = __fadd_rn(dst[k], src[k]);
  }
  const bool lead = key >= 0 && !alone && (peers & below) == 0;
  const unsigned leaders = __ballot_sync(PT_FULL, lead);
  if (leaders == 0) return;
  if (lead) {
    const int r = __popc(leaders & below);
    order[r] = lane;
    order[32 + r] = (int)peers;
    order[64 + r] = key;
  }
  __syncwarp();
  const int ngroups = __popc(leaders);
  const int per = 32 / f;
  const int sub = lane / f;
  const int k = lane - sub * f;
  if (sub < per) {
    for (int g = sub; g < ngroups; g += per) {
      const int first = order[g];
      unsigned rest = (unsigned)order[32 + g];
      rest &= rest - 1;
      float acc = rows[first * f + k];
      while (rest) {
        const int m = __ffs(rest) - 1;
        rest &= rest - 1;
        acc = __fadd_rn(acc, rows[m * f + k]);
      }
      float* dst = table + (size_t)order[64 + g] * f + k;
      *dst = __fadd_rn(*dst, acc);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ float pt_add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 pt_add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// src[0] + src[stride] + ... + src[(nrows - 1) * stride], in that order,
// read through L2 (the rows were written by other blocks).
template <typename V>
__device__ __forceinline__ V pt_sum_rows(const V* src, size_t stride,
                                         int nrows) {
  V acc = __ldcg(src);
#pragma unroll 8
  for (int r = 1; r < nrows; ++r) acc = pt_add(acc, __ldcg(src + r * stride));
  return acc;
}

// dst[i] = sum of nrows rows of src at i (rows stride elements apart), for
// i < len, by the whole block; float4 where len allows it (the same sums).
__device__ __forceinline__ void pt_block_sum_rows(const float* src,
                                                  size_t stride, int nrows,
                                                  int len, float* dst) {
  if (len % 4 == 0 && stride % 4 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < len / 4; i += blockDim.x) {
      d4[i] = pt_sum_rows(s4 + i, stride / 4, nrows);
    }
  } else {
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      dst[i] = pt_sum_rows(src + i, stride, nrows);
    }
  }
}

// The cross-block pass in the same launch. Every block of the grid calls
// it after writing its partial (row blockIdx.x of `partials`, len floats,
// rows len apart). The last block of each group of PT_GROUP blocks to
// finish (an integer ticket after a __threadfence) sums the group's rows in
// block order into the group's first row; the last group to finish sums
// the groups' first rows in group order into out. counters: (groups + 1)
// ints, zero on entry, zero again when the grid is done.
__device__ void pt_finish_partials(float* partials, int len, float* out,
                                   unsigned* counters) {
  __shared__ bool last;
  const int nblocks = gridDim.x;
  const int g = blockIdx.x / PT_GROUP;
  const int b0 = g * PT_GROUP;
  const int nrows = min(nblocks - b0, PT_GROUP);
  const int ngroups = (nblocks + PT_GROUP - 1) / PT_GROUP;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&counters[g], 1u) == (unsigned)(nrows - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* row0 = partials + (size_t)b0 * len;
  pt_block_sum_rows(row0, len, nrows, len, row0);
  if (threadIdx.x == 0) counters[g] = 0;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&counters[ngroups], 1u) == (unsigned)(ngroups - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  pt_block_sum_rows(partials, (size_t)PT_GROUP * len, ngroups, len, out);
  if (threadIdx.x == 0) counters[ngroups] = 0;
}

// The same sums as pt_finish_partials as a kernel of its own, laid out for
// coalesced reads: a block of PT_THREADS threads per 32 outputs, warp w
// summing groups w, w + 8, ... (each in block order, lane = output), warp 0
// then the groups in group order.
__global__ void pt_sum_groups(const float* __restrict__ partials,
                              int nblocks, int len,
                              float* __restrict__ out) {
  __shared__ float gsum[PT_MAX_GROUPS][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * 32 + lane;
  const int ngroups = (nblocks + PT_GROUP - 1) / PT_GROUP;
  for (int g = warp; g < ngroups; g += blockDim.x >> 5) {
    const int b0 = g * PT_GROUP;
    gsum[g][lane] = i < len ? pt_sum_rows(partials + (size_t)b0 * len + i,
                                          len, min(nblocks - b0, PT_GROUP))
                            : 0.0f;
  }
  __syncthreads();
  if (warp == 0 && i < len) {
    float acc = gsum[0][lane];
    for (int g = 1; g < ngroups; ++g) acc = __fadd_rn(acc, gsum[g][lane]);
    out[i] = acc;
  }
}

// Opt a kernel into `bytes` of dynamic shared memory once per device and
// process (done: one entry per device, the bytes already granted).
constexpr int PT_MAX_DEVICES = 64;

template <typename Kernel>
cudaError_t pt_opt_in_smem(Kernel kernel, int bytes, int* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < PT_MAX_DEVICES && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < PT_MAX_DEVICES) done[dev] = bytes;
  return err;
}

}  // namespace
