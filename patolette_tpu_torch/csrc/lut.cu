// K5: the 24-bit nearest-palette table.
//
// Replaces patolette_tpu/ops/lut.py::_argmin_lut (and the argmin half of
// build_lut_device): for every uint8 sRGB code, the index of the nearest
// valid palette entry in ICtCp, written as u8 (P <= 256) or u16
// (P <= 65536). The JAX package scanned (P, chunk) distance tiles over the
// cached grid; here the grid's three planes are the "pixels" of
// nearest.cuh's scan (the one K3 runs), so the table equals K3's direct map
// of the same grid bit for bit. The grid itself (sRGB -> working -> ICtCp
// of each code) is torch glue (ops/lut.py): CUDA's pow differs from the
// glue's f64-rounded power in the last bit, and the table would then
// disagree with the direct map on some codes.
//
// Bound on the H100: f32 operations, seven per (code, valid entry): at
// P = 256, 2^24 x 256 x 7 = 3.0e10, 0.45 ms at 67 TFLOP/s, against 201 MB
// of grid and 16.8 MB of table (0.065 ms at 3.35 TB/s).
#include <stdint.h>

#include "nearest.cuh"

// a, b, c: the (N,) grid planes; cent: (K, 4) rows [c0, c1, c2, |c|^2];
// valid: (K,) int32; out: (N,) of out_bytes (1: u8, 2: u16) per entry.
PT_EXPORT int pt_lut_argmin(const float* a, const float* b, const float* c,
                            const float* cent, const int* valid, int n, int k,
                            void* out, int out_bytes, void* stream) {
  if (out_bytes == 1 && k <= 256) {
    return launch_nearest<uint8_t>(a, b, c, cent, valid, n, k,
                                   (uint8_t*)out, stream);
  }
  if (out_bytes == 2 && k <= 65536) {
    return launch_nearest<uint16_t>(a, b, c, cent, valid, n, k,
                                    (uint16_t*)out, stream);
  }
  return (int)cudaErrorInvalidValue;
}
