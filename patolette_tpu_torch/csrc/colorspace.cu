// K10: the colour-transform composites, one elementwise pass per call.
//
// Replaces patolette_tpu/ops/colorspace.py's composites srgb_to_working
// (:353), working_to_ictcp (:376), working_to_linear_rec2020 (:365),
// srgb_to_lab (:329) and srgb_to_linear_rec2020 (:301), with the feeds
// around them fused in: the uint8 upload's normalisation and
// de-interleave (_put/_upload, pipeline.py:117 _to_working), the 24-bit
// codes of the LUT grid (lut.py:87 _codes_to_ictcp) and the packed dither
// feed's direct sRGB -> linear Rec2020 chain (dither.py:220). XLA fused
// each composite into one loop on the TPU; the port's torch glue runs
// dozens of elementwise launches and f64 transients per conversion. Here
// one thread converts one pixel in registers and writes three planes.
//
// Bit identity with the glue (ops/colorspace.py), which the LUT table's
// equality with the direct map and the PQ curve's ~80x amplification of
// an ulp both need: every op is spelled with its rounding. _fma is an f64
// multiply and add rounded once to f32 (__dmul_rn, __dadd_rn,
// __double2float_rn); _div multiplies by the f32 reciprocal; _pow is
// pow(double, double) (the libdevice function torch's CUDA pow reaches for
// these exponents) with the exponent rounded to f32 first; every Python
// constant meets an f32 value as its f32 rounding, written F32(v) below
// (a double literal cast to float, as numpy rounds it); clamps keep NaN as
// torch's do. No a*b+c is left for nvcc to contract.
//
// Bound on the H100: device-memory bytes, 12 B (f32), 3 B (uint8) or 4 B
// (codes) read and 12 B written per pixel, against ~10-40 f64 operations
// a pixel when a pow counts as one (libdevice's double pow is tens of
// instructions, and the f64 rate is half the f32 rate).
#include "common.cuh"

namespace {

#define F32(v) ((float)(double)(v))
// _div's constant: x * fl32(1 / fl32(k))
#define RCP(k) ((float)(1.0 / (double)F32(k)))
// the exponent of a _pow: the f32 value of the Python float, widened
#define EXP(e) ((double)F32(e))

constexpr int kInF32 = 0;    // f32, three planes or (N, 3) interleaved
constexpr int kInU8 = 1;     // uint8 (N, 3), each byte times f32(1/255)
constexpr int kInCodes = 2;  // int32 r << 16 | g << 8 | b

constexpr int kWorking = 0;        // sRGB -> working
constexpr int kIctcp = 1;          // sRGB -> working -> ICtCp
constexpr int kRec2020 = 2;        // sRGB -> working -> linear Rec2020
constexpr int kRec2020Direct = 3;  // sRGB -> linear Rec2020
constexpr int kLab = 4;            // sRGB -> CIELAB
constexpr int kWorkIctcp = 5;      // working -> ICtCp
constexpr int kWorkRec2020 = 6;    // working -> linear Rec2020

constexpr double kPqM1 = 0.1593017578125;
constexpr double kPqM2 = 78.84375;
constexpr double kPqC1 = 0.8359375;
constexpr double kPqC2 = 18.8515625;
constexpr double kPqC3 = 18.6875;
constexpr double kPqLp = 10000.0;
constexpr double kD65X = 0.95047;
constexpr double kD65Y = 1.0;
constexpr double kD65Z = 1.08883;
constexpr double kRefDen = kD65X + 15.0 * kD65Y + 3.0 * kD65Z;
constexpr double kUr = 4.0 * kD65X / kRefDen;
constexpr double kVr = 9.0 * kD65Y / kRefDen;
constexpr double kKE = 216.0 / 24389.0;
constexpr double kKK = 24389.0 / 27.0;
constexpr double kKKE = 8.0;

// Matrices, row-major, each entry the f32 value the glue computes with.
#define M_SRGB_TO_XYZ                                                   \
  F32(0.4124564), F32(0.3575761), F32(0.1804375), F32(0.2126729),       \
      F32(0.7151522), F32(0.0721750), F32(0.0193339), F32(0.1191920),   \
      F32(0.9503041)
#define M_XYZ_TO_SRGB                                                   \
  F32(3.2404542), F32(-1.5371385), F32(-0.4985314), F32(-0.9692660),    \
      F32(1.8760108), F32(0.0415560), F32(0.0556434), F32(-0.2040259),  \
      F32(1.0572252)
#define M_XYZ_TO_REC2020                                                 \
  F32(1.71666343), F32(-0.35567332), F32(-0.25336809), F32(-0.66667384), \
      F32(1.61645574), F32(0.0157683), F32(0.01764248),                  \
      F32(-0.04277698), F32(0.94224328)
#define M_REC2020_TO_XYZ                                               \
  F32(0.63695351), F32(0.14461919), F32(0.16885585), F32(0.26269834),  \
      F32(0.67800877), F32(0.0592929), F32(0.0), F32(0.02807314),      \
      F32(1.06082723)
#define M_REC2020_TO_LMS                                                \
  F32(1688.0 / 4096.0), F32(2146.0 / 4096.0), F32(262.0 / 4096.0),      \
      F32(683.0 / 4096.0), F32(2951.0 / 4096.0), F32(462.0 / 4096.0),   \
      F32(99.0 / 4096.0), F32(309.0 / 4096.0), F32(3688.0 / 4096.0)
// the Ct row halved (reference ICtCp.c:74-78)
#define M_LMSP_TO_ICTCP                                                     \
  F32(0.5), F32(0.5), F32(0.0), F32(0.5 * 6610.0 / 4096.0),                 \
      F32(0.5 * -13613.0 / 4096.0), F32(0.5 * 7003.0 / 4096.0),             \
      F32(17933.0 / 4096.0), F32(-17390.0 / 4096.0), F32(-543.0 / 4096.0)
// the Ct column doubled (reference rec2020.c:51-56)
#define M_ICTCP_TO_LMSP                                                  \
  F32(1.0), F32(2.0 * 0.00860904), F32(0.11102963), F32(1.0),            \
      F32(2.0 * -0.00860904), F32(-0.11102963), F32(1.0),                \
      F32(2.0 * 0.56003134), F32(-0.32062717)
// LMS -> linear Rec2020 with the EOTF's PQ_LP scale folded in, as
// ictcp_to_linear_rec2020 folds it: fl32(fl32(v) * fl32(PQ_LP))
#define PQS(v) ((float)((double)F32(v) * (double)F32(kPqLp)))
#define M_LMS_TO_REC2020_PQ                                              \
  PQS(3.43660669), PQS(-2.50645212), PQS(0.06984542), PQS(-0.79132956),  \
      PQS(1.98360045), PQS(-0.1922709), PQS(-0.0259499),                 \
      PQS(-0.09891371), PQS(1.12486361)

struct V3 {
  float a, b, c;
};

// _fma: x * y + z through f64, rounded once to f32
__device__ __forceinline__ float fma64(float x, double y, double z) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)x, y), z));
}

// _pow: x ** e through f64, rounded once to f32 (kept out of line: one
// copy of libdevice's pow per kernel image instead of one per call site)
__device__ __noinline__ float pow64(float x, double e) {
  return __double2float_rn(pow((double)x, e));
}

// torch.clamp_min(x, 0) and torch.clamp(x, 0, 1): NaN passes through
__device__ __forceinline__ float clamp0(float x) {
  return isnan(x) ? x : fmaxf(x, 0.0f);
}
__device__ __forceinline__ float clamp01(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

// One output of a 3x3 product as _row contracts it: fma(c, m2, fma(a, m0,
// m1 b)), a and b swapped when m0 is the only negative of the two or 1.
__device__ __forceinline__ float row(float a, float b, float c, float m0,
                                     float m1, float m2) {
  const float ab = ((m0 < 0.0f && 0.0f <= m1) || m0 == 1.0f)
                       ? fma64(b, m1, __fmul_rn(a, m0))
                       : fma64(a, m0, __fmul_rn(b, m1));
  return fma64(c, m2, ab);
}

__device__ __forceinline__ V3 mat(V3 v, float m00, float m01, float m02,
                                  float m10, float m11, float m12, float m20,
                                  float m21, float m22) {
  return {row(v.a, v.b, v.c, m00, m01, m02), row(v.a, v.b, v.c, m10, m11, m12),
          row(v.a, v.b, v.c, m20, m21, m22)};
}

// sRGB transfer function (srgb_gamma_decode)
__device__ __forceinline__ float gamma_decode(float c) {
  const float lin =
      c <= F32(0.0404500)
          ? __fmul_rn(c, RCP(12.92))
          : pow64(__fmul_rn(clamp0(__fadd_rn(c, F32(0.055))), RCP(1.055)),
                  EXP(2.4));
  return clamp01(lin);
}

// its inverse (srgb_gamma_encode)
__device__ __forceinline__ float gamma_encode(float c) {
  const float enc =
      c <= F32(0.0031308)
          ? __fmul_rn(c, F32(12.92))
          : fma64(pow64(clamp0(c), EXP(1.0 / 2.4)), (double)F32(1.055),
                  (double)F32(-0.055));
  return clamp01(enc);
}

// ST 2084 EOTF before its PQ_LP scale (_pq_eotf_unit)
__device__ __forceinline__ float pq_unit(float v) {
  const float vp = pow64(clamp0(v), EXP(1.0 / kPqM2));
  const float n = clamp0(__fsub_rn(vp, F32(kPqC1)));
  return pow64(
      __fdiv_rn(n, fma64(vp, -(double)F32(kPqC3), (double)F32(kPqC2))),
      EXP(1.0 / kPqM1));
}

// its inverse (pq_eotf_inverse)
__device__ __forceinline__ float pq_inverse(float f) {
  const float y = pow64(__fmul_rn(clamp0(f), RCP(kPqLp)), EXP(kPqM1));
  return pow64(__fdiv_rn(fma64(y, (double)F32(kPqC2), (double)F32(kPqC1)),
                         fma64(y, (double)F32(kPqC3), 1.0)),
               EXP(kPqM2));
}

__device__ __forceinline__ V3 srgb_to_xyz(V3 v) {
  return mat({gamma_decode(v.a), gamma_decode(v.b), gamma_decode(v.c)},
             M_SRGB_TO_XYZ);
}

__device__ __forceinline__ V3 xyz_to_srgb(V3 v) {
  const V3 l = mat(v, M_XYZ_TO_SRGB);
  return {gamma_encode(l.a), gamma_encode(l.b), gamma_encode(l.c)};
}

__device__ __forceinline__ V3 srgb_to_rec2020(V3 v) {
  return mat(srgb_to_xyz(v), M_XYZ_TO_REC2020);
}

__device__ __forceinline__ V3 rec2020_to_srgb(V3 v) {
  return xyz_to_srgb(mat(v, M_REC2020_TO_XYZ));
}

__device__ __forceinline__ V3 rec2020_to_ictcp(V3 v) {
  const V3 lms = mat(v, M_REC2020_TO_LMS);
  return mat({pq_inverse(lms.a), pq_inverse(lms.b), pq_inverse(lms.c)},
             M_LMSP_TO_ICTCP);
}

__device__ __forceinline__ V3 ictcp_to_rec2020(V3 v) {
  const V3 lmsp = mat(v, M_ICTCP_TO_LMSP);
  return mat({pq_unit(lmsp.a), pq_unit(lmsp.b), pq_unit(lmsp.c)},
             M_LMS_TO_REC2020_PQ);
}

__device__ __forceinline__ V3 srgb_to_ictcp(V3 v) {
  return rec2020_to_ictcp(srgb_to_rec2020(v));
}

// CIE XYZ -> CIELuv, D65 (xyz_to_cieluv); y / D65_Y is y (torch divides
// by a scalar as a multiply by its reciprocal, here 1)
__device__ __forceinline__ V3 xyz_to_luv(V3 v) {
  const float x = v.a, y = v.b, z = v.c;
  const float den = fma64(z, 3.0, (double)fma64(y, 15.0, (double)x));
  const bool safe = den > 0.0f;
  const float ds = safe ? den : 1.0f;
  const float up = safe ? __fdiv_rn(__fmul_rn(x, 4.0f), ds) : 0.0f;
  const float vp = safe ? __fdiv_rn(__fmul_rn(y, 9.0f), ds) : 0.0f;
  const float l = y > F32(kKE)
                      ? fma64(pow64(clamp0(y), EXP(1.0 / 3.0)), 116.0, -16.0)
                      : __fmul_rn(y, F32(kKK));
  const float l13 = __fmul_rn(l, 13.0f);
  return {l, __fmul_rn(l13, __fsub_rn(up, F32(kUr))),
          __fmul_rn(l13, __fsub_rn(vp, F32(kVr)))};
}

// CIELuv -> CIE XYZ with the zero-denominator guards (cieluv_to_xyz)
__device__ __forceinline__ V3 luv_to_xyz(V3 v) {
  const float l = v.a, u = v.b, w = v.c;
  float y;
  if (l > F32(kKKE)) {
    const float t = __fmul_rn(__fadd_rn(l, 16.0f), RCP(116.0));
    y = __fmul_rn(__fmul_rn(t, t), t);
  } else {
    y = __fmul_rn(l, RCP(kKK));
  }
  const float l13 = __fmul_rn(l, 13.0f);
  const float a_den = fma64(l13, (double)F32(kUr), (double)u);
  const float a =
      a_den != 0.0f
          ? __fmul_rn(__fsub_rn(__fdiv_rn(__fmul_rn(l, 52.0f), a_den), 1.0f),
                      RCP(3.0))
          : 0.0f;
  const float b = __fmul_rn(y, -5.0f);
  const float d_den = fma64(l13, (double)F32(kVr), (double)w);
  const float d =
      d_den != 0.0f
          ? __fmul_rn(y, __fsub_rn(__fdiv_rn(__fmul_rn(l, 39.0f), d_den), 5.0f))
          : 0.0f;
  const float x_den = __fsub_rn(a, F32(-1.0 / 3.0));
  const float x = x_den != 0.0f ? __fdiv_rn(__fsub_rn(d, b), x_den) : 0.0f;
  return {x, y, fma64(x, (double)a, (double)b)};
}

__device__ __forceinline__ V3 luv_to_rec2020(V3 v) {
  return mat(luv_to_xyz(v), M_XYZ_TO_REC2020);
}

// f(t) of CIELAB (srgb_to_lab's fwhite)
__device__ __forceinline__ float lab_f(float t) {
  return t > F32(kKE) ? pow64(t, EXP(1.0 / 3.0))
                      : __fmul_rn(fma64(t, (double)F32(kKK), 16.0), RCP(116.0));
}

__device__ __forceinline__ V3 srgb_to_lab(V3 v) {
  const V3 xyz = srgb_to_xyz(v);
  const float fx = lab_f(__fmul_rn(xyz.a, RCP(kD65X)));
  const float fy = lab_f(__fmul_rn(xyz.b, RCP(kD65Y)));
  const float fz = lab_f(__fmul_rn(xyz.c, RCP(kD65Z)));
  return {fma64(fy, 116.0, -16.0), __fmul_rn(__fsub_rn(fx, fy), 500.0f),
          __fmul_rn(__fsub_rn(fy, fz), 200.0f)};
}

template <int CS>
__device__ __forceinline__ V3 srgb_to_working(V3 v) {
  if constexpr (CS == 1) {
    return xyz_to_luv(srgb_to_xyz(v));
  } else if constexpr (CS == 2) {
    return srgb_to_ictcp(v);
  } else {
    return v;
  }
}

// the CIELuv chain is the reference's Luv -> Rec2020 -> sRGB -> ICtCp
template <int CS>
__device__ __forceinline__ V3 working_to_ictcp(V3 v) {
  if constexpr (CS == 1) {
    return srgb_to_ictcp(rec2020_to_srgb(luv_to_rec2020(v)));
  } else if constexpr (CS == 2) {
    return v;
  } else {
    return srgb_to_ictcp(v);
  }
}

template <int CS>
__device__ __forceinline__ V3 working_to_rec2020(V3 v) {
  if constexpr (CS == 1) {
    return luv_to_rec2020(v);
  } else if constexpr (CS == 2) {
    return ictcp_to_rec2020(v);
  } else {
    return srgb_to_rec2020(v);
  }
}

template <int CS, int T>
__device__ __forceinline__ V3 convert(V3 v) {
  if constexpr (T == kWorking) {
    return srgb_to_working<CS>(v);
  } else if constexpr (T == kIctcp) {
    return working_to_ictcp<CS>(srgb_to_working<CS>(v));
  } else if constexpr (T == kRec2020) {
    return working_to_rec2020<CS>(srgb_to_working<CS>(v));
  } else if constexpr (T == kRec2020Direct) {
    return srgb_to_rec2020(v);
  } else if constexpr (T == kLab) {
    return srgb_to_lab(v);
  } else if constexpr (T == kWorkIctcp) {
    return working_to_ictcp<CS>(v);
  } else {
    return working_to_rec2020<CS>(v);
  }
}

template <int IN>
__device__ __forceinline__ V3 load(const void* x0, const void* x1,
                                   const void* x2, long long stride,
                                   long long i) {
  if constexpr (IN == kInF32) {
    return {((const float*)x0)[i * stride], ((const float*)x1)[i * stride],
            ((const float*)x2)[i * stride]};
  } else if constexpr (IN == kInU8) {
    const float s = F32(1.0 / 255.0);
    return {__fmul_rn((float)((const unsigned char*)x0)[i * stride], s),
            __fmul_rn((float)((const unsigned char*)x1)[i * stride], s),
            __fmul_rn((float)((const unsigned char*)x2)[i * stride], s)};
  } else {
    const float s = F32(1.0 / 255.0);
    const int code = ((const int*)x0)[i];
    return {__fmul_rn((float)((code >> 16) & 0xFF), s),
            __fmul_rn((float)((code >> 8) & 0xFF), s),
            __fmul_rn((float)(code & 0xFF), s)};
  }
}

template <int IN, int CS, int T>
__global__ void color_kernel(const void* __restrict__ x0,
                             const void* __restrict__ x1,
                             const void* __restrict__ x2, long long stride,
                             long long n, float* __restrict__ o0,
                             float* __restrict__ o1, float* __restrict__ o2) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const V3 r = convert<CS, T>(load<IN>(x0, x1, x2, stride, i));
    o0[i] = r.a;
    o1[i] = r.b;
    o2[i] = r.c;
  }
}

struct Args {
  const void *x0, *x1, *x2;
  long long stride, n;
  float *o0, *o1, *o2;
  cudaStream_t stream;
};

template <int IN, int CS, int T>
int launch(const Args& a) {
  // the working-space targets take f32 only; the direct chain and Lab do
  // not depend on the working space and are built for space 0 alone
  if constexpr ((T == kWorkIctcp || T == kWorkRec2020) && IN != kInF32) {
    return (int)cudaErrorInvalidValue;
  } else if constexpr ((T == kRec2020Direct || T == kLab) && CS != 0) {
    return launch<IN, 0, T>(a);
  } else {
    const int threads = 256;
    long long blocks = (a.n + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    color_kernel<IN, CS, T><<<(int)blocks, threads, 0, a.stream>>>(
        a.x0, a.x1, a.x2, a.stride, a.n, a.o0, a.o1, a.o2);
    return (int)cudaGetLastError();
  }
}

template <int IN, int CS>
int by_target(int target, const Args& a) {
  switch (target) {
    case kWorking: return launch<IN, CS, kWorking>(a);
    case kIctcp: return launch<IN, CS, kIctcp>(a);
    case kRec2020: return launch<IN, CS, kRec2020>(a);
    case kRec2020Direct: return launch<IN, CS, kRec2020Direct>(a);
    case kLab: return launch<IN, CS, kLab>(a);
    case kWorkIctcp: return launch<IN, CS, kWorkIctcp>(a);
    case kWorkRec2020: return launch<IN, CS, kWorkRec2020>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int IN>
int by_space(int cs, int target, const Args& a) {
  switch (cs) {
    case 0: return by_target<IN, 0>(target, a);
    case 1: return by_target<IN, 1>(target, a);
    case 2: return by_target<IN, 2>(target, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x0, x1, x2: the three input channels (element pointers; for (N, 3)
// input the base and the next two elements, stride 3), or x0 the (N,)
// codes; in_kind 0 f32, 1 uint8, 2 int32 codes; color_space 0 sRGB, 1
// CIELuv, 2 ICtCp; target as the k* constants above; o0..o2: (N,) f32.
PT_EXPORT int pt_color_convert(const void* x0, const void* x1, const void* x2,
                               int in_kind, long long stride, long long n,
                               int color_space, int target, void* o0,
                               void* o1, void* o2, void* stream) {
  const Args a{x0,          x1,          x2,          stride,
               n,           (float*)o0,  (float*)o1,  (float*)o2,
               (cudaStream_t)stream};
  switch (in_kind) {
    case kInF32: return by_space<kInF32>(color_space, target, a);
    case kInU8: return by_space<kInU8>(color_space, target, a);
    case kInCodes: return by_space<kInCodes>(color_space, target, a);
    default: return (int)cudaErrorInvalidValue;
  }
}
