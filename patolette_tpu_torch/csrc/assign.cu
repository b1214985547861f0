// K3: nearest centre for channel-planar pixels.
//
// Replaces patolette_tpu/ops/assign.py::assign_planar (and the blocks of
// assign): the JAX package built a (chunk, K) distance matrix from three
// rank-1 products on the TPU's vector unit; here each thread keeps its
// pixels' running minimum in registers and nothing of size N x K exists.
// The scan itself is nearest.cuh's, shared with K5 (csrc/lut.cu), pruned
// by each warp's box of pixel values as K5's is.
//
// Bound on the H100: f32 operations. Seven per (pixel, centre) for the
// brute-force scan: at the 4K direct map (N = 8,294,400, K = 256) 14.9
// GFLOP, ~0.22 ms at 67 TFLOP/s, against 133 MB of pixel and label traffic
// (~0.04 ms); the pruned scan does that work only for the centres listed.
#include "nearest.cuh"

// cent: (K, 4) rows [c0, c1, c2, |c|^2]; valid: (K,) int32; labels: (N,).
PT_EXPORT int pt_assign_planar(const float* a, const float* b, const float* c,
                               const float* cent, const int* valid, int n,
                               int k, int* labels, void* stream) {
  return launch_nearest<int, false>(a, b, c, cent, valid, n, k, labels,
                                    nullptr, stream);
}
