// K7: Hilbert-curve index of every pixel.
//
// Replaces patolette_tpu/ops/hilbert.py::xy_to_d as pixel_visit_order calls
// it (all N row-major pixels of a width x height image): the classic
// iterative xy -> d rotation loop over `order` levels, in uint32, exact
// through order 16 (d < 4^16 = 2^32; the 40000 px side cap gives order 16).
// The keys are written widened to int64 so that torch's sort takes them
// (its CUDA sort of uint32 is thin); the argsort stays a torch sort, as the
// JAX package's jnp.argsort sits outside any kernel body. The keys are
// distinct, so the permutation is exact and deterministic.
//
// Bound on the H100: device-memory bytes, 8 B of key written per pixel
// (the coordinates come from the index): 66 MB at 4K, ~0.02 ms at
// 3.35 TB/s. The loop is ~15 integer ops a level, 12 levels at 4K.
#include "common.cuh"

namespace {

__global__ void hilbert_keys_kernel(long long n, int width, int order,
                                    long long* __restrict__ keys) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    unsigned x = (unsigned)(i % width);
    unsigned y = (unsigned)(i / width);
    unsigned d = 0;
    for (unsigned s = 1u << (order - 1); s > 0; s >>= 1) {
      const unsigned rx = (x & s) ? 1u : 0u;
      const unsigned ry = (y & s) ? 1u : 0u;
      d += s * s * ((3u * rx) ^ ry);
      if (ry == 0) {  // rotate the quadrant (unsigned wrap as in the JAX code)
        if (rx == 1) {
          x = (s - 1) - x;
          y = (s - 1) - y;
        }
        const unsigned t = x;
        x = y;
        y = t;
      }
    }
    keys[i] = (long long)d;
  }
}

}  // namespace

// keys: (n,) int64 with n = width * height; order in [1, 16].
PT_EXPORT int pt_hilbert_keys(long long n, int width, int order, void* keys,
                              void* stream) {
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535 * 16) blocks = 65535 * 16;
  hilbert_keys_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      n, width, order, (long long*)keys);
  return (int)cudaGetLastError();
}
