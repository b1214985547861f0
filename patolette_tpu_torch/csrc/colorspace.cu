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
// pow(double, double) rounded to f32 (pow64: the libdevice function
// torch's CUDA pow reaches for these exponents) with the exponent rounded
// to f32 first; every Python constant meets an f32 value as its f32
// rounding, written F32(v) below (a double literal cast to float, as numpy
// rounds it); clamps keep NaN as torch's do. No a*b+c is left for nvcc to
// contract.
//
// Fewer pows, the same bits:
//   * byte inputs (uint8 pixels, codes): the sRGB decode sees one of 256
//     values, byte * f32(1/255). Every block first fills a 256-entry table
//     in shared memory with gamma_decode of those values, and the grid is
//     persistent (a few blocks an SM, each striding over the pixels), so
//     the table costs 256 decodes a block, not three a pixel: the packed
//     dither feed runs no pow at all, the codes' ICtCp only the PQ curve's
//     six.
//   * every pow is pow_exact: x^e from a short f64 evaluation (log2 by a
//     128-entry table and a degree-6 polynomial, 2^t by a 128-entry table
//     and a degree-5 polynomial, every op rounded to nearest, no FMA) whose
//     error, with libdevice pow's own (2 ulp), is below 2^-44.5 relative
//     for every f32 x with an f32-normal result (the bound is worked out
//     at pow_fast). Its f32 rounding is returned when every value within
//     2^-40 relative of it rounds to the same f32 (Ziv's test, on the
//     bits: the 29 bits below the f32 mantissa at least 2^13 away from the
//     halfway point); pow64 itself, out of line, otherwise, and for every
//     x that is not a positive finite f32 but 0 (whose power is +0). So
//     pow_exact(x, e) == pow64(x, e) for every f32 x, which
//     pt_pow_exact_check counts on the card over all 2^32 x of an exponent.
//
// Bound on the H100: device-memory bytes, 12 B (f32), 3 B (uint8) or 4 B
// (codes) read and 12 B written per pixel, against up to ~40 f64
// operations a pixel besides the pows (each fma64 also converts twice,
// and conversions to and from f64 issue at a quarter of the f64 rate) and
// ~35 f64 operations a pow_exact.
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

// pow_fast's tables, hexadecimal doubles. kLogTab[i] = {c_i, -log2(c_i)}:
// c_i is 1 / (1 + (i + 1/2) / 128) rounded to 29 significant bits, so m
// c_i - 1 is exact for m of 24 bits; -log2(c_i) rounded to nearest.
// kExp2Tab[j] = 2^(j / 128) rounded to nearest. kLogPoly: (-1)^(k+1) / (k
// ln 2), k = 1..6 (log2(1 + r) = r (a1 + r (a2 + ...))); kExpPoly: ln(2)^k
// / k!, k = 1..5 (2^g = 1 + g (b1 + g (b2 + ...))).
__device__ const double2 kLogTab[128] = {
    {0x1.fe01fe0000000p-1, 0x1.709c4848ff3ddp-8},
    {0x1.fa11caa000000p-1, 0x1.136311805d02ap-6},
    {0x1.f6310ad000000p-1, 0x1.c9363a906ef6cp-6},
    {0x1.f25f644000000p-1, 0x1.3ed3097a75830p-5},
    {0x1.ee9c7f8000000p-1, 0x1.985bfc9c74da9p-5},
    {0x1.eae807b000000p-1, 0x1.f13897c9d4244p-5},
    {0x1.e741aa6000000p-1, 0x1.24b5b791dc7e6p-4},
    {0x1.e3a917a000000p-1, 0x1.507b8344ca76ap-4},
    {0x1.e01e01e000000p-1, 0x1.7beee96cfb7c9p-4},
    {0x1.dca01dd000000p-1, 0x1.a7111da8fbcb7p-4},
    {0x1.d92f223000000p-1, 0x1.d1e34e4d861f4p-4},
    {0x1.d5cac80000000p-1, 0x1.fc66a14d0527ep-4},
    {0x1.d272ca4000000p-1, 0x1.134e1b471f0e7p-3},
    {0x1.cf26e5c000000p-1, 0x1.284294cbe3a8cp-3},
    {0x1.cbe6d96000000p-1, 0x1.3d1146da61508p-3},
    {0x1.c8b265b000000p-1, 0x1.51bab905d81f1p-3},
    {0x1.c5894d1000000p-1, 0x1.663f6fb1fa2e2p-3},
    {0x1.c26b539000000p-1, 0x1.7a9fec90237d1p-3},
    {0x1.bf583ef000000p-1, 0x1.8edcae51307fbp-3},
    {0x1.bc4fd66000000p-1, 0x1.a2f6320045a4cp-3},
    {0x1.b951e2b000000p-1, 0x1.b6ecf1806f02fp-3},
    {0x1.b65e2e4000000p-1, 0x1.cac163ac0797cp-3},
    {0x1.b37484b000000p-1, 0x1.de73fe2a20e08p-3},
    {0x1.b094b32000000p-1, 0x1.f205338171a72p-3},
    {0x1.adbe880000000p-1, 0x1.02baba0dbb1edp-2},
    {0x1.aaf1d30000000p-1, 0x1.0c62973b4ab8ap-2},
    {0x1.a82e651000000p-1, 0x1.15fa6776545eep-2},
    {0x1.a574107000000p-1, 0x1.1f825f846ffe1p-2},
    {0x1.a2c2a88000000p-1, 0x1.28fab34e36701p-2},
    {0x1.a01a01a000000p-1, 0x1.326396370ed87p-2},
    {0x1.9d79f17000000p-1, 0x1.3bbd3a2219ebep-2},
    {0x1.9ae24ea000000p-1, 0x1.4507d000f29b6p-2},
    {0x1.9852f0e000000p-1, 0x1.4e4387f4f41b7p-2},
    {0x1.95cbb0c000000p-1, 0x1.577091acb9909p-2},
    {0x1.934c680000000p-1, 0x1.608f1b2b7f437p-2},
    {0x1.90d4f12000000p-1, 0x1.699f524929a0ap-2},
    {0x1.8e6527b000000p-1, 0x1.72a163794eef9p-2},
    {0x1.8bfce80000000p-1, 0x1.7b957adc2ff3bp-2},
    {0x1.899c0f6000000p-1, 0x1.847bc33de26e0p-2},
    {0x1.87427bd000000p-1, 0x1.8d54672c646adp-2},
    {0x1.84f00c2000000p-1, 0x1.961f906ef24dep-2},
    {0x1.82a4a02000000p-1, 0x1.9edd673bc2c56p-2},
    {0x1.8060180000000p-1, 0x1.a78e14869136bp-2},
    {0x1.7e22551000000p-1, 0x1.b031bf13d860cp-2},
    {0x1.7beb392000000p-1, 0x1.b8c88dcab6b63p-2},
    {0x1.79baa6c000000p-1, 0x1.c152a6b0440e9p-2},
    {0x1.7790812000000p-1, 0x1.c9d02f53c18a4p-2},
    {0x1.756cac2000000p-1, 0x1.d2414c811b7cfp-2},
    {0x1.734f0c5000000p-1, 0x1.daa62230ce1c5p-2},
    {0x1.713786e000000p-1, 0x1.e2fed3b7b4389p-2},
    {0x1.6f26017000000p-1, 0x1.eb4b8479a8945p-2},
    {0x1.6d1a627000000p-1, 0x1.f38c565be0e75p-2},
    {0x1.6b1490b000000p-1, 0x1.fbc16b7886b99p-2},
    {0x1.691473b000000p-1, 0x1.01f57267e941ep-1},
    {0x1.6719f36000000p-1, 0x1.0604719f5315bp-1},
    {0x1.6524f85000000p-1, 0x1.0a0dc35738307p-1},
    {0x1.63356b9000000p-1, 0x1.0e1177459ab4fp-1},
    {0x1.614b368000000p-1, 0x1.120f9d405f7c8p-1},
    {0x1.5f66434000000p-1, 0x1.1608444ec6fd2p-1},
    {0x1.5d867c4000000p-1, 0x1.19fb7b8cabee5p-1},
    {0x1.5babcc6000000p-1, 0x1.1de951e35a89fp-1},
    {0x1.59d61f1000000p-1, 0x1.21d1d5c034c17p-1},
    {0x1.5805601000000p-1, 0x1.25b5159743b3dp-1},
    {0x1.56397ba000000p-1, 0x1.29931f7856cbep-1},
    {0x1.54725e7000000p-1, 0x1.2d6c012bb7a85p-1},
    {0x1.52aff57000000p-1, 0x1.313fc895b5611p-1},
    {0x1.50f22e1000000p-1, 0x1.350e8327dfbc1p-1},
    {0x1.4f38f63000000p-1, 0x1.38d83dfe2e68dp-1},
    {0x1.4d843bf000000p-1, 0x1.3c9d0644154edp-1},
    {0x1.4bd3ede000000p-1, 0x1.405ce8c71dd34p-1},
    {0x1.4a27fad000000p-1, 0x1.4417f25d024c5p-1},
    {0x1.4880522000000p-1, 0x1.47ce2f2d30830p-1},
    {0x1.46dce34000000p-1, 0x1.4b7fabcae91c6p-1},
    {0x1.453d9e3000000p-1, 0x1.4f2c741298ce1p-1},
    {0x1.43a2731000000p-1, 0x1.52d4942249828p-1},
    {0x1.420b526000000p-1, 0x1.567817c5f17aap-1},
    {0x1.40782d1000000p-1, 0x1.5a170a4e0bbf3p-1},
    {0x1.3ee8f43000000p-1, 0x1.5db1774371065p-1},
    {0x1.3d5d992000000p-1, 0x1.614769f6a9981p-1},
    {0x1.3bd60d9000000p-1, 0x1.64d8ed7c3d7bep-1},
    {0x1.3a52438000000p-1, 0x1.68660ca8ff984p-1},
    {0x1.38d22d3000000p-1, 0x1.6beed2341bbc7p-1},
    {0x1.3755bd2000000p-1, 0x1.6f7348b43ee66p-1},
    {0x1.35dce60000000p-1, 0x1.72f37ac2df0e6p-1},
    {0x1.34679ad000000p-1, 0x1.766f72ad9c771p-1},
    {0x1.32f5ced000000p-1, 0x1.79e73a98f6186p-1},
    {0x1.3187759000000p-1, 0x1.7d5adc56b176fp-1},
    {0x1.301c82b000000p-1, 0x1.80ca61fd797a6p-1},
    {0x1.2eb4ea2000000p-1, 0x1.8435d54c754cbp-1},
    {0x1.2d50a01000000p-1, 0x1.879d3fcea51d8p-1},
    {0x1.2bef98e000000p-1, 0x1.8b00aaff50178p-1},
    {0x1.2a91c93000000p-1, 0x1.8e60202058a73p-1},
    {0x1.293725c000000p-1, 0x1.91bba886c321fp-1},
    {0x1.27dfa39000000p-1, 0x1.95134d499ba1cp-1},
    {0x1.268b37d000000p-1, 0x1.986717670e719p-1},
    {0x1.2539d7f000000p-1, 0x1.9bb70f99f5d9fp-1},
    {0x1.23eb797000000p-1, 0x1.9f033ed040fddp-1},
    {0x1.22a0123000000p-1, 0x1.a24bad5f42ab5p-1},
    {0x1.2157980000000p-1, 0x1.a590641cbbf9fp-1},
    {0x1.2012012000000p-1, 0x1.a8d16b18109eep-1},
    {0x1.1ecf43c000000p-1, 0x1.ac0ecade20275p-1},
    {0x1.1d8f567000000p-1, 0x1.af488b58f5138p-1},
    {0x1.1c522fc000000p-1, 0x1.b27eb4c43f5b2p-1},
    {0x1.1b17c68000000p-1, 0x1.b5b14f06cf67bp-1},
    {0x1.19e011a000000p-1, 0x1.b8e062034c5e6p-1},
    {0x1.18ab084000000p-1, 0x1.bc0bf56cbe6b7p-1},
    {0x1.1778a19000000p-1, 0x1.bf341118df87ap-1},
    {0x1.1648d51000000p-1, 0x1.c258bc55c2ed9p-1},
    {0x1.151b9a4000000p-1, 0x1.c579febaff106p-1},
    {0x1.13f0e8d000000p-1, 0x1.c897dfa99a68ep-1},
    {0x1.12c8b8a000000p-1, 0x1.cbb26649befbep-1},
    {0x1.11a301a000000p-1, 0x1.cec999decd53ep-1},
    {0x1.107fbbe000000p-1, 0x1.d1dd819b7a69ap-1},
    {0x1.0f5edfb000000p-1, 0x1.d4ee244949554p-1},
    {0x1.0e40656000000p-1, 0x1.d7fb88f43cde6p-1},
    {0x1.0d24456000000p-1, 0x1.db05b6936230cp-1},
    {0x1.0c0a787000000p-1, 0x1.de0cb38318011p-1},
    {0x1.0af2f72000000p-1, 0x1.e11086e314c48p-1},
    {0x1.09ddba7000000p-1, 0x1.e41136dceb719p-1},
    {0x1.08cabb3000000p-1, 0x1.e70eca5c67654p-1},
    {0x1.07b9f2a000000p-1, 0x1.ea094752724b2p-1},
    {0x1.06ab59c000000p-1, 0x1.ed00b49e06600p-1},
    {0x1.059eea0000000p-1, 0x1.eff5181f2fdcbp-1},
    {0x1.04949cc000000p-1, 0x1.f2e6781be32c9p-1},
    {0x1.038c6b8000000p-1, 0x1.f5d4dab896cecp-1},
    {0x1.02864fc000000p-1, 0x1.f8c0465230646p-1},
    {0x1.0182436000000p-1, 0x1.fba8c06aefc52p-1},
    {0x1.0080402000000p-1, 0x1.fe8e4f15eb449p-1},
};
__device__ const double kExp2Tab[128] = {
    0x1.0000000000000p+0, 0x1.0163da9fb3335p+0, 0x1.02c9a3e778061p+0,
    0x1.04315e86e7f85p+0, 0x1.059b0d3158574p+0, 0x1.0706b29ddf6dep+0,
    0x1.0874518759bc8p+0, 0x1.09e3ecac6f383p+0, 0x1.0b5586cf9890fp+0,
    0x1.0cc922b7247f7p+0, 0x1.0e3ec32d3d1a2p+0, 0x1.0fb66affed31bp+0,
    0x1.11301d0125b51p+0, 0x1.12abdc06c31ccp+0, 0x1.1429aaea92de0p+0,
    0x1.15a98c8a58e51p+0, 0x1.172b83c7d517bp+0, 0x1.18af9388c8deap+0,
    0x1.1a35beb6fcb75p+0, 0x1.1bbe084045cd4p+0, 0x1.1d4873168b9aap+0,
    0x1.1ed5022fcd91dp+0, 0x1.2063b88628cd6p+0, 0x1.21f49917ddc96p+0,
    0x1.2387a6e756238p+0, 0x1.251ce4fb2a63fp+0, 0x1.26b4565e27cddp+0,
    0x1.284dfe1f56381p+0, 0x1.29e9df51fdee1p+0, 0x1.2b87fd0dad990p+0,
    0x1.2d285a6e4030bp+0, 0x1.2ecafa93e2f56p+0, 0x1.306fe0a31b715p+0,
    0x1.32170fc4cd831p+0, 0x1.33c08b26416ffp+0, 0x1.356c55f929ff1p+0,
    0x1.371a7373aa9cbp+0, 0x1.38cae6d05d866p+0, 0x1.3a7db34e59ff7p+0,
    0x1.3c32dc313a8e5p+0, 0x1.3dea64c123422p+0, 0x1.3fa4504ac801cp+0,
    0x1.4160a21f72e2ap+0, 0x1.431f5d950a897p+0, 0x1.44e086061892dp+0,
    0x1.46a41ed1d0057p+0, 0x1.486a2b5c13cd0p+0, 0x1.4a32af0d7d3dep+0,
    0x1.4bfdad5362a27p+0, 0x1.4dcb299fddd0dp+0, 0x1.4f9b2769d2ca7p+0,
    0x1.516daa2cf6642p+0, 0x1.5342b569d4f82p+0, 0x1.551a4ca5d920fp+0,
    0x1.56f4736b527dap+0, 0x1.58d12d497c7fdp+0, 0x1.5ab07dd485429p+0,
    0x1.5c9268a5946b7p+0, 0x1.5e76f15ad2148p+0, 0x1.605e1b976dc09p+0,
    0x1.6247eb03a5585p+0, 0x1.6434634ccc320p+0, 0x1.6623882552225p+0,
    0x1.68155d44ca973p+0, 0x1.6a09e667f3bcdp+0, 0x1.6c012750bdabfp+0,
    0x1.6dfb23c651a2fp+0, 0x1.6ff7df9519484p+0, 0x1.71f75e8ec5f74p+0,
    0x1.73f9a48a58174p+0, 0x1.75feb564267c9p+0, 0x1.780694fde5d3fp+0,
    0x1.7a11473eb0187p+0, 0x1.7c1ed0130c132p+0, 0x1.7e2f336cf4e62p+0,
    0x1.80427543e1a12p+0, 0x1.82589994cce13p+0, 0x1.8471a4623c7adp+0,
    0x1.868d99b4492edp+0, 0x1.88ac7d98a6699p+0, 0x1.8ace5422aa0dbp+0,
    0x1.8cf3216b5448cp+0, 0x1.8f1ae99157736p+0, 0x1.9145b0b91ffc6p+0,
    0x1.93737b0cdc5e5p+0, 0x1.95a44cbc8520fp+0, 0x1.97d829fde4e50p+0,
    0x1.9a0f170ca07bap+0, 0x1.9c49182a3f090p+0, 0x1.9e86319e32323p+0,
    0x1.a0c667b5de565p+0, 0x1.a309bec4a2d33p+0, 0x1.a5503b23e255dp+0,
    0x1.a799e1330b358p+0, 0x1.a9e6b5579fdbfp+0, 0x1.ac36bbfd3f37ap+0,
    0x1.ae89f995ad3adp+0, 0x1.b0e07298db666p+0, 0x1.b33a2b84f15fbp+0,
    0x1.b59728de5593ap+0, 0x1.b7f76f2fb5e47p+0, 0x1.ba5b030a1064ap+0,
    0x1.bcc1e904bc1d2p+0, 0x1.bf2c25bd71e09p+0, 0x1.c199bdd85529cp+0,
    0x1.c40ab5fffd07ap+0, 0x1.c67f12e57d14bp+0, 0x1.c8f6d9406e7b5p+0,
    0x1.cb720dcef9069p+0, 0x1.cdf0b555dc3fap+0, 0x1.d072d4a07897cp+0,
    0x1.d2f87080d89f2p+0, 0x1.d5818dcfba487p+0, 0x1.d80e316c98398p+0,
    0x1.da9e603db3285p+0, 0x1.dd321f301b460p+0, 0x1.dfc97337b9b5fp+0,
    0x1.e264614f5a129p+0, 0x1.e502ee78b3ff6p+0, 0x1.e7a51fbc74c83p+0,
    0x1.ea4afa2a490dap+0, 0x1.ecf482d8e67f1p+0, 0x1.efa1bee615a27p+0,
    0x1.f252b376bba97p+0, 0x1.f50765b6e4540p+0, 0x1.f7bfdad9cbe14p+0,
    0x1.fa7c1819e90d8p+0, 0x1.fd3c22b8f71f1p+0,
};
__constant__ double kLogPoly[6] = {0x1.71547652b82fep+0, -0x1.71547652b82fep-1, 0x1.ec709dc3a03fdp-2,
                                -0x1.71547652b82fep-2, 0x1.2776c50ef9bfep-2, -0x1.ec709dc3a03fdp-3};
__constant__ double kExpPoly[5] = {0x1.62e42fefa39efp-1, 0x1.ebfbdff82c58fp-3, 0x1.c6b08d704a0c0p-5,
                                0x1.3b2ab6fba4e77p-7, 0x1.5d87fe78a6731p-10};

// x^e for a positive finite f32 x, in f64; 0 when |e log2 x| >= 150 (the
// f32 result is then 0 or inf; the caller's range test sends it to pow64).
// With u = 2^-53 (|e| <= 78.85, |t| < 150):
//   x = 2^k m, m in [1, 2) (x widened exactly), i = the top 7 bits of m's
//   fraction; r = m c_i - 1 exact, |r| <= 2^-8 (+ 2^-28);
//   log2(1 + r) by the polynomial: truncation |r|^7 / (7 ln 2) < 2^-58,
//   Horner's roundings < 2^-58 (|p| < 2^-7.4);
//   s = -log2(c_i) + p: the table's 2^-54, the sum's u, |s| < 1: < 2^-52.2;
//   L = k + s: + u |L|; t = e L: + u |t|; so |t - e log2 x| <= |e| 2^-52.2
//   + 2 u |t| < 2^-44.2 for |t| < 150;
//   2^t = 2^q 2^(j/128) 2^g, t = (128 q + j) / 128 + g, |g| <= 2^-8, g
//   exact (Sterbenz); the polynomial's truncation < 2^-60, its roundings
//   < 3u, the table's u, the product's u, 2^q exact;
//   so |y - x^e| / x^e < ln 2 2^-44.2 + 6u < 2^-44.6, and with libdevice
//   pow's 2 ulp (2^-51) |y - pow(x, e)| < 2^-44.5 y.
__device__ __forceinline__ double pow_fast(float x, double e) {
  const double xd = (double)x;
  const long long bits = __double_as_longlong(xd);
  const int k = (int)(bits >> 52) - 1023;
  const double m =
      __longlong_as_double((bits & 0x000FFFFFFFFFFFFFLL) | 0x3FF0000000000000LL);
  const double2 cl = kLogTab[(bits >> 45) & 127];
  const double r = __dadd_rn(__dmul_rn(m, cl.x), -1.0);
  double p = kLogPoly[5];
#pragma unroll
  for (int i = 4; i >= 0; --i) p = __dadd_rn(__dmul_rn(p, r), kLogPoly[i]);
  p = __dmul_rn(p, r);
  const double t = __dmul_rn(e, __dadd_rn((double)k, __dadd_rn(cl.y, p)));
  if (!(fabs(t) < 150.0)) return 0.0;
  const long long n = __double2ll_rn(__dmul_rn(t, 128.0));
  const double g = __dadd_rn(t, -(double)n * 0.0078125);
  double q = kExpPoly[4];
#pragma unroll
  for (int i = 3; i >= 0; --i) q = __dadd_rn(__dmul_rn(q, g), kExpPoly[i]);
  q = __dadd_rn(__dmul_rn(q, g), 1.0);
  const double scale = __longlong_as_double((long long)((n >> 7) + 1023) << 52);
  return __dmul_rn(__dmul_rn(kExp2Tab[n & 127], q), scale);
}

// Ziv's test: true when every value within 2^-40 y of y rounds to the f32
// y rounds to (y's 29 bits below the f32 mantissa more than 2^13 from the
// halfway point 2^28, y's exponent in the f32-normal range).
__device__ __forceinline__ bool rounds_clear(double y) {
  const long long bits = __double_as_longlong(y);
  const int ex = (int)(bits >> 52) - 1023;
  const int low = (int)(bits & 0x1FFFFFFF) - (1 << 28);
  return ex >= -126 && ex <= 127 && (low > (1 << 13) || low < -(1 << 13));
}

// pow64(x, e) for every f32 x, for the exponents here (positive, not odd
// integers); *fell (when given) is set where pow64 ran.
__device__ __forceinline__ float pow_exact(float x, double e,
                                           bool* fell = nullptr) {
  if (x == 0.0f) return 0.0f;
  if (x > 0.0f && x < INFINITY) {
    const double y = pow_fast(x, e);
    if (rounds_clear(y)) return __double2float_rn(y);
  }
  if (fell) *fell = true;
  return pow64(x, e);
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
          : pow_exact(
                __fmul_rn(clamp0(__fadd_rn(c, F32(0.055))), RCP(1.055)),
                EXP(2.4));
  return clamp01(lin);
}

// its inverse (srgb_gamma_encode)
__device__ __forceinline__ float gamma_encode(float c) {
  const float enc =
      c <= F32(0.0031308)
          ? __fmul_rn(c, F32(12.92))
          : fma64(pow_exact(clamp0(c), EXP(1.0 / 2.4)), (double)F32(1.055),
                  (double)F32(-0.055));
  return clamp01(enc);
}

// ST 2084 EOTF before its PQ_LP scale (_pq_eotf_unit)
__device__ __forceinline__ float pq_unit(float v) {
  const float vp = pow_exact(clamp0(v), EXP(1.0 / kPqM2));
  const float n = clamp0(__fsub_rn(vp, F32(kPqC1)));
  return pow_exact(
      __fdiv_rn(n, fma64(vp, -(double)F32(kPqC3), (double)F32(kPqC2))),
      EXP(1.0 / kPqM1));
}

// its inverse (pq_eotf_inverse)
__device__ __forceinline__ float pq_inverse(float f) {
  const float y = pow_exact(__fmul_rn(clamp0(f), RCP(kPqLp)), EXP(kPqM1));
  return pow_exact(
      __fdiv_rn(fma64(y, (double)F32(kPqC2), (double)F32(kPqC1)),
                fma64(y, (double)F32(kPqC3), 1.0)),
      EXP(kPqM2));
}

__device__ __forceinline__ V3 decode3(V3 v) {
  return {gamma_decode(v.a), gamma_decode(v.b), gamma_decode(v.c)};
}

// linear sRGB -> CIE XYZ (srgb_to_xyz after its decode)
__device__ __forceinline__ V3 linear_to_xyz(V3 lin) {
  return mat(lin, M_SRGB_TO_XYZ);
}

__device__ __forceinline__ V3 xyz_to_srgb(V3 v) {
  const V3 l = mat(v, M_XYZ_TO_SRGB);
  return {gamma_encode(l.a), gamma_encode(l.b), gamma_encode(l.c)};
}

__device__ __forceinline__ V3 linear_to_rec2020(V3 lin) {
  return mat(linear_to_xyz(lin), M_XYZ_TO_REC2020);
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

__device__ __forceinline__ V3 linear_to_ictcp(V3 lin) {
  return rec2020_to_ictcp(linear_to_rec2020(lin));
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
                      ? fma64(pow_exact(clamp0(y), EXP(1.0 / 3.0)), 116.0,
                              -16.0)
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
  return t > F32(kKE) ? pow_exact(t, EXP(1.0 / 3.0))
                      : __fmul_rn(fma64(t, (double)F32(kKK), 16.0), RCP(116.0));
}

__device__ __forceinline__ V3 linear_to_lab(V3 lin) {
  const V3 xyz = linear_to_xyz(lin);
  const float fx = lab_f(__fmul_rn(xyz.a, RCP(kD65X)));
  const float fy = lab_f(__fmul_rn(xyz.b, RCP(kD65Y)));
  const float fz = lab_f(__fmul_rn(xyz.c, RCP(kD65Z)));
  return {fma64(fy, 116.0, -16.0), __fmul_rn(__fsub_rn(fx, fy), 500.0f),
          __fmul_rn(__fsub_rn(fy, fz), 200.0f)};
}

// An input pixel: its sRGB (or, for the working_to_* targets, working)
// values and, for byte inputs (kTab), its three bytes, whose decodes are
// entries of the block's table: tab[i] == gamma_decode(i * f32(1/255)),
// the decode of the value v holds, so linear() gives the same bits either
// way.
template <bool kTab>
struct Px {
  V3 v;
  int i0, i1, i2;
  const float* tab;
};

template <bool kTab>
__device__ __forceinline__ V3 linear(const Px<kTab>& p) {
  if constexpr (kTab) {
    return {p.tab[p.i0], p.tab[p.i1], p.tab[p.i2]};
  } else {
    return decode3(p.v);
  }
}

template <int CS, bool kTab>
__device__ __forceinline__ V3 srgb_to_working(const Px<kTab>& p) {
  if constexpr (CS == 1) {
    return xyz_to_luv(linear_to_xyz(linear(p)));
  } else if constexpr (CS == 2) {
    return linear_to_ictcp(linear(p));
  } else {
    return p.v;
  }
}

// the CIELuv chain is the reference's Luv -> Rec2020 -> sRGB -> ICtCp
template <int CS>
__device__ __forceinline__ V3 working_to_ictcp(V3 v) {
  if constexpr (CS == 1) {
    return linear_to_ictcp(decode3(rec2020_to_srgb(luv_to_rec2020(v))));
  } else if constexpr (CS == 2) {
    return v;
  } else {
    return linear_to_ictcp(decode3(v));
  }
}

template <int CS>
__device__ __forceinline__ V3 working_to_rec2020(V3 v) {
  if constexpr (CS == 1) {
    return luv_to_rec2020(v);
  } else if constexpr (CS == 2) {
    return ictcp_to_rec2020(v);
  } else {
    return linear_to_rec2020(decode3(v));
  }
}

// (in sRGB space the working value is the input, so its decode is the
// input's: linear(p))
template <int CS, int T, bool kTab>
__device__ __forceinline__ V3 convert(const Px<kTab>& p) {
  if constexpr (T == kWorking) {
    return srgb_to_working<CS>(p);
  } else if constexpr (T == kIctcp) {
    if constexpr (CS == 0) {
      return linear_to_ictcp(linear(p));
    } else {
      return working_to_ictcp<CS>(srgb_to_working<CS>(p));
    }
  } else if constexpr (T == kRec2020) {
    if constexpr (CS == 0) {
      return linear_to_rec2020(linear(p));
    } else {
      return working_to_rec2020<CS>(srgb_to_working<CS>(p));
    }
  } else if constexpr (T == kRec2020Direct) {
    return linear_to_rec2020(linear(p));
  } else if constexpr (T == kLab) {
    return linear_to_lab(linear(p));
  } else if constexpr (T == kWorkIctcp) {
    return working_to_ictcp<CS>(p.v);
  } else {
    return working_to_rec2020<CS>(p.v);
  }
}

template <int IN>
__device__ __forceinline__ Px<IN != kInF32> load(const void* x0,
                                                 const void* x1,
                                                 const void* x2,
                                                 long long stride,
                                                 long long i,
                                                 const float* tab) {
  const float s = F32(1.0 / 255.0);
  if constexpr (IN == kInF32) {
    return {{((const float*)x0)[i * stride], ((const float*)x1)[i * stride],
             ((const float*)x2)[i * stride]},
            0, 0, 0, tab};
  } else {
    int r, g, b;
    if constexpr (IN == kInU8) {
      r = ((const unsigned char*)x0)[i * stride];
      g = ((const unsigned char*)x1)[i * stride];
      b = ((const unsigned char*)x2)[i * stride];
    } else {
      const int code = ((const int*)x0)[i];
      r = (code >> 16) & 0xFF;
      g = (code >> 8) & 0xFF;
      b = code & 0xFF;
    }
    return {{__fmul_rn((float)r, s), __fmul_rn((float)g, s),
             __fmul_rn((float)b, s)},
            r, g, b, tab};
  }
}

template <int IN, int CS, int T>
__global__ void color_kernel(const void* __restrict__ x0,
                             const void* __restrict__ x1,
                             const void* __restrict__ x2, long long stride,
                             long long n, float* __restrict__ o0,
                             float* __restrict__ o1, float* __restrict__ o2) {
  constexpr bool kTab = IN != kInF32;
  __shared__ float tab[kTab ? 256 : 1];
  if constexpr (kTab) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      tab[i] = gamma_decode(__fmul_rn((float)i, F32(1.0 / 255.0)));
    }
    __syncthreads();
  }
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const V3 r = convert<CS, T>(load<IN>(x0, x1, x2, stride, i, tab));
    o0[i] = r.a;
    o1[i] = r.b;
    o2[i] = r.c;
  }
}

// Counts over all 2^32 f32 bit patterns x, for one exponent e: counts[0]
// += the x where pow_exact(x, e) and pow64(x, e) differ in any bit;
// counts[1] += the positive finite x where pow_exact ran pow64; counts[2]
// and counts[3] += the same and all positive finite x, among those whose
// power is an f32-normal number.
__global__ void pow_check_kernel(double e,
                                 unsigned long long* __restrict__ counts) {
  unsigned long long tally[4] = {0, 0, 0, 0};
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       i < (1ull << 32); i += step) {
    const float x = __uint_as_float((unsigned)i);
    bool ran = false;
    const float got = pow_exact(x, e, &ran);
    const float want = pow64(x, e);
    const bool pos = x > 0.0f && x < INFINITY;
    const bool normal = pos && want >= 1.17549435e-38f && want < INFINITY;
    tally[0] += __float_as_uint(got) != __float_as_uint(want);
    tally[1] += ran && pos;
    tally[2] += ran && normal;
    tally[3] += normal;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      tally[c] += __shfl_xor_sync(PT_FULL, tally[c], off);
    }
    if ((threadIdx.x & 31) == 0) atomicAdd(&counts[c], tally[c]);
  }
}

// Blocks of a launch: at most kBlocksPerSm an SM, so each block's table is
// amortised over many pixels (a block of 256 threads).
constexpr int kColorThreads = 256;
constexpr int kBlocksPerSm = 8;
int g_sms[PT_MAX_DEVICES];

long long color_blocks(long long n) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= PT_MAX_DEVICES) return 0;
  if (g_sms[dev] == 0 &&
      cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess) {
    return 0;
  }
  const long long blocks = (n + kColorThreads - 1) / kColorThreads;
  return blocks < (long long)g_sms[dev] * kBlocksPerSm
             ? blocks
             : (long long)g_sms[dev] * kBlocksPerSm;
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
    const long long blocks = color_blocks(a.n);
    if (blocks <= 0) return (int)cudaErrorInvalidDevice;
    color_kernel<IN, CS, T><<<(int)blocks, kColorThreads, 0, a.stream>>>(
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

// pow_exact against pow64 over every f32 x for exponent e (a check, not on
// any path): counts, 4 zeroed u64 on the device, as pow_check_kernel's.
PT_EXPORT int pt_pow_exact_check(double e, void* counts, void* stream) {
  pow_check_kernel<<<4096, 256, 0, (cudaStream_t)stream>>>(
      e, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}
