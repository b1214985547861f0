// Host half of the 24-bit LUT route: pack (N, 3) uint8 sRGB pixels into
// 24-bit codes (r << 16 | g << 8 | b) and resolve them through the (2^24,)
// table K5 built, on POSIX threads, into the int32 palette map; and decode
// a table slice from K6's run words (the multi-device route).
//
// Counterpart of the JAX package's native gather (lut_map_u8), written anew
// for the port: one pass over the pixels with the codes packed in
// registers. The work is bound by host memory: 3 bytes read and 4 written a pixel,
// plus the table reads (16.8 MB u8 or 33.5 MB u16, mostly cache hits on an
// image's coherent colours).
//
// Plain C interface, built with the host C++ compiler at first use
// (kernels/build.py::host_library) and loaded with ctypes; it uses only
// pthreads, so the library depends on nothing but the C library.
#include <pthread.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#define PT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kMaxThreads = 64;

struct Job {
  const uint8_t* px;      // (N, 3) pixels
  const void* table;      // (2^24,) entries of table_bytes each
  int table_bytes;
  int32_t* out;           // (N,) map
  long long begin, end;
};

inline int32_t pack(const uint8_t* p) {
  return ((int32_t)p[0] << 16) | ((int32_t)p[1] << 8) | (int32_t)p[2];
}

template <typename T>
void gather(const Job& j) {
  const T* tab = (const T*)j.table;
  for (long long i = j.begin; i < j.end; ++i) {
    j.out[i] = tab[pack(j.px + 3 * i)];
  }
}

void* work(void* arg) {
  const Job& j = *(const Job*)arg;
  if (j.table_bytes == 1) {
    gather<uint8_t>(j);
  } else if (j.table_bytes == 2) {
    gather<uint16_t>(j);
  } else {
    gather<int32_t>(j);
  }
  return nullptr;
}

// Split [0, n) into nthreads contiguous ranges; the calling thread runs the
// first, and any range whose thread could not be started.
void run(Job proto, long long n, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > kMaxThreads) nthreads = kMaxThreads;
  if (n < (1 << 16)) nthreads = 1;
  Job jobs[kMaxThreads];
  pthread_t tid[kMaxThreads];
  const long long per = (n + nthreads - 1) / nthreads;
  int started = 0, err = 0;
  for (int t = 0; t < nthreads; ++t) {
    jobs[t] = proto;
    jobs[t].begin = t * per < n ? t * per : n;
    jobs[t].end = (t + 1) * per < n ? (t + 1) * per : n;
  }
  for (int t = 1; t < nthreads; ++t) {
    err = pthread_create(&tid[t], nullptr, work, &jobs[t]);
    if (err) break;
    started = t;
  }
  work(&jobs[0]);
  for (int t = 1; t <= started; ++t) pthread_join(tid[t], nullptr);
  if (err) {
    for (int t = started + 1; t < nthreads; ++t) work(&jobs[t]);
  }
}

}  // namespace

// px: (N, 3) uint8; table: (2^24,) of table_bytes (1, 2 or 4) each;
// out: (N,) int32. Returns 0, or 1 for another entry size.
PT_EXPORT int pt_lut_map(const uint8_t* px, long long n, const void* table,
                         int table_bytes, int32_t* out, int nthreads) {
  if (table_bytes != 1 && table_bytes != 2 && table_bytes != 4) return 1;
  Job j = {px, table, table_bytes, out, 0, 0};
  run(j, n, nthreads);
  return 0;
}

// words: (count,) u16 run words w_i = (delta_i << 8) | value_i (K6's v2
// format without its header), delta_0 = 0; out: (size,) u8. Run i fills
// [start_i, start_{i+1}) with start_count = size, one memset a run
// (counterpart of the JAX package's native rle_decode_u8_v2). Returns 0,
// or 2 for words that do not describe a (size,) table.
PT_EXPORT int pt_rle_decode_u8_v2(const uint16_t* words, long long count,
                                  uint8_t* out, long long size) {
  if (count < 1 || (words[0] >> 8) != 0) return 2;
  long long start = 0;
  for (long long i = 0; i < count; ++i) {
    long long next = size;
    if (i + 1 < count) {
      const long long d = words[i + 1] >> 8;
      if (d < 1) return 2;
      next = start + d;
    }
    if (next > size || next <= start) return 2;
    memset(out + start, words[i] & 0xFF, (size_t)(next - start));
    start = next;
  }
  return 0;
}

// words: (count,) u32 run words w_i = (pos_i << 8) | value_i (K6's v1
// format without its header), pos_0 = 0 and positions strictly ascending;
// out: (size,) u8. Run i fills [pos_i, pos_{i+1}) with pos_count = size
// (counterpart of the JAX package's native rle_decode_u8). Returns 0, or 2
// for words that do not describe a (size,) table. A one-entry run of 255 at
// 2^24 - 1 has the word 0xFFFFFFFF, a run like any other.
PT_EXPORT int pt_rle_decode_u8(const uint32_t* words, long long count,
                               uint8_t* out, long long size) {
  if (count < 1 || (words[0] >> 8) != 0) return 2;
  for (long long i = 0; i < count; ++i) {
    const long long start = words[i] >> 8;
    const long long next = i + 1 < count ? (long long)(words[i + 1] >> 8)
                                         : size;
    if (next <= start || next > size) return 2;
    memset(out + start, words[i] & 0xFF, (size_t)(next - start));
  }
  return 0;
}

// words: (count,) u32 run words w_i = (delta_i << 16) | value_i (K6's u16
// v2 format without its header), delta_0 = 0; out: (size,) u16. As
// pt_rle_decode_u8_v2 for u16 entries (counterpart of the JAX package's
// native rle_decode_u16_v2). Returns 0, or 2 for words that do not describe
// a (size,) table.
PT_EXPORT int pt_rle_decode_u16_v2(const uint32_t* words, long long count,
                                   uint16_t* out, long long size) {
  if (count < 1 || (words[0] >> 16) != 0) return 2;
  long long start = 0;
  for (long long i = 0; i < count; ++i) {
    long long next = size;
    if (i + 1 < count) {
      const long long d = words[i + 1] >> 16;
      if (d < 1) return 2;
      next = start + d;
    }
    if (next > size || next <= start) return 2;
    std::fill(out + start, out + next, (uint16_t)(words[i] & 0xFFFF));
    start = next;
  }
  return 0;
}
