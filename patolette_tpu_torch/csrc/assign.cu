// K3: nearest centre for channel-planar pixels.
//
// Replaces patolette_tpu/ops/assign.py::assign_planar (and the blocks of
// assign): the JAX package built a (chunk, K) distance matrix from three
// rank-1 products on the TPU's vector unit; here each thread keeps its
// pixels' running minimum in registers and nothing of size N x K exists.
// The scan itself is nearest.cuh's, shared with K5 (csrc/lut.cu), pruned
// by each warp's box of pixel values as K5's is; K3 takes the sorted
// layout there: a block cuts its tile of 8192 consecutive pixels by median
// splits of the widest channel in shared memory, so that a warp's 256
// points are a tight colour box rather than 8 runs of 32 pixels of a row
// (whose box on an image holds nearly every centre: 252.7 of 253 on the
// synthetic 4K image, against 26.9 after the splits), and writes each label
// back to its pixel's own index. Why the grouping cannot change a label is
// argued at nearest_sorted_kernel.
//
// Bound on the H100: device-memory bytes once the scan is pruned, 133 MB
// of pixels read and labels written at the 4K direct map (N = 8,294,400,
// K = 256), ~0.040 ms at 3.35 TB/s. Beside it, the brute-force scan's 7
// unfused f32 operations per (pixel, valid centre), 14.7 GFLOP: ~0.44 ms at
// the f32 instruction rate of 33.5 T/s (these do not fuse, so the 67
// TFLOP/s FMA-counted peak does not apply); the pruned scan does that work
// only for the centres listed.
#include "nearest.cuh"

// cent: (K, 4) rows [c0, c1, c2, |c|^2]; valid: (K,) int32; labels: (N,).
PT_EXPORT int pt_assign_planar(const float* a, const float* b, const float* c,
                               const float* cent, const int* valid, int n,
                               int k, int* labels, void* stream) {
  return launch_nearest_sorted<kSortThreads>(a, b, c, cent, valid, n, k,
                                             labels, nullptr, stream);
}
