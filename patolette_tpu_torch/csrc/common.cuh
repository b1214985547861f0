// Shared helpers of the port's kernels.
//
// Determinism rule of every kernel here: no float atomics, in global or in
// shared memory. A block builds its partial sums with "owner scans": each
// output slot is written by exactly one thread, which walks the block's
// pixels in order; per-block partials are then summed in block order by a
// second kernel. The same inputs give the same bits on every run.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

// Pixels staged in shared memory per step of a block's walk.
constexpr int PT_STAGE = 256;
// Threads of an accumulating block.
constexpr int PT_THREADS = 256;

// Each source is compiled on its own and linked into one library, so the
// helpers below have internal linkage.
namespace {

// Sum over blocks, in block order: out[i] = sum_b partials[b * len + i].
__global__ void pt_sum_partials(const float* __restrict__ partials,
                                int nblocks, int len,
                                float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float acc = 0.0f;
  for (int b = 0; b < nblocks; ++b) {
    acc = __fadd_rn(acc, partials[(size_t)b * len + i]);
  }
  out[i] = acc;
}

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

}  // namespace
