// K9: minimum barrier distance, three raster passes, one launch a pass.
//
// Replaces patolette_tpu/models/saliency.py::_wavefront_pass (the three
// passes mbd() runs: inverse, forward, inverse). Each cell's update reads
// two neighbours that the same pass has already updated: (x-1, y) and
// (x, y-1) forward, (x+1, y) and (x, y+1) inverse. The barrier through a
// neighbour is max(U, I) - min(L, I); a cell keeps its d when d is no
// larger than both, else takes neighbour 1 when b1 < d and b1 <= b2, else
// neighbour 2. Forward updates x in [1, rows-2], y in [1, cols-2]; inverse
// x in [2, rows-2], y in [2, cols-2]. Min, max and one subtraction: the
// result is exact, so kernel, plain version and JAX agree bit for bit.
//
// Bound on the H100: device-memory bytes. The first pass reads img and
// writes l, u, d; the others read img, l, u, d and write l, u, d: (16 +
// 28 + 28) B x N, 597 MB at 4K, ~0.18 ms at 3.35 TB/s. What costs more is the serial chain: a band
// walks cols + 31 dependent steps (a shuffle, min, max, a subtraction,
// compares and selects), and each band starts about two super-steps (64
// steps) after the band above.
//
// Design. A pass runs in logical coordinates (X, Y): the image itself
// forward, the image turned by 180 degrees inverse (X = rows-1-x, Y =
// cols-1-y), so both read (X-1, Y) (neighbour 1) and (X, Y-1) (neighbour
// 2) and update X in [1, xhi], Y in [1, yhi]. One block owns a band of 32
// rows. Its walker warp holds one row a lane and walks the band's columns
// as a systolic wavefront: at step k lane r updates column Y = 1 + k - r.
// Neighbour 2 is the lane's own result of the step before (registers);
// neighbour 1 is lane r-1's result of the step before (__shfl_up_sync);
// lane 0 reads the row above from shared memory. The walker touches no
// global memory in its steps: two more warps carry the traffic.
// - Super-steps of 32 steps: during super-step s the walker walks chunks
//   (32 columns) s-1 and s; the stager copies chunk s+2 into shared memory
//   by rows (cp.async, lane = column) and fetches the row above chunk s+1;
//   the writer takes chunk s-2 (finished when super-step s-1 ended), hands
//   its last row to the band below and writes it back by rows. The three
//   warps meet at a named barrier after each super-step; five chunk
//   buffers (80 KB) rotate. With rows of 32 floats the 32 cells of a
//   diagonal sit in 32 banks.
// - Bands are handed out by an integer ticket taken when the block starts,
//   not by blockIdx, so a band waits only on a band that is already
//   running: no deadlock, whatever the residency (four processes sharing
//   the card included). The last ticket taker puts the ticket back to 0.
// - The hand-over between bands is a row of 64-bit words per band
//   (`bnd`): (l, u) packed so that no valid pair packs to 0 (l is +inf
//   and u is -inf in no pair: l <= u, or both are NaN). A word is its own
//   flag: the writer of the band above stores a finished chunk's last row
//   as words before writing the chunk back; the stager of the band below
//   spins while a word reads 0 (and traps after 20 s, a fault, rather than
//   hang) and puts it back to 0 once read. Relaxed loads and stores at
//   device scope: no fences. Band 0's row above is row 0, which no pass
//   updates. The words are 0 again when the launch ends, so the next pass
//   finds them cleared. (A progress counter a band, release and acquire,
//   with the row read from the planes, needs no words but was slower: the
//   fence and the second round trip add to every band's start.)
// - The first pass also initialises the planes (l = u = img, d = 0 on the
//   border and +inf elsewhere): it reads only img, and the writers write
//   the cells no pass updates. Three launches a call, nothing else.
#include "common.cuh"

namespace {

constexpr int kRing = 5;         // chunk buffers a warp cycles through
constexpr int kTile = 32 * 32;   // one plane of a chunk: 32 rows x 32 cols
constexpr int kSmem = kRing * 4 * kTile * (int)sizeof(float);  // 80 KB
int g_smem_init[PT_MAX_DEVICES];
int g_smem_pass[PT_MAX_DEVICES];

struct Chunk {
  float img[kTile], d[kTile], l[kTile], u[kTile];
};

struct Pass {
  int rows, cols, xhi, yhi, inverse;
  __device__ __forceinline__ size_t at(int x, int y) const {
    if (inverse) {
      x = rows - 1 - x;
      y = cols - 1 - y;
    }
    return (size_t)x * cols + y;
  }
  __device__ __forceinline__ bool border(int x, int y) const {
    return x == 0 || y == 0 || x == rows - 1 || y == cols - 1;
  }
};

// (l, u) -> a word that is 0 only for l = +inf, u = -inf (no valid pair).
__device__ __forceinline__ unsigned long long pack(float l, float u) {
  return ((unsigned long long)(__float_as_uint(u) ^ 0xff800000u) << 32) |
         (__float_as_uint(l) ^ 0x7f800000u);
}

__device__ __forceinline__ float2 unpack(unsigned long long v) {
  return make_float2(__uint_as_float((unsigned)v ^ 0x7f800000u),
                     __uint_as_float((unsigned)(v >> 32) ^ 0xff800000u));
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v));
}

// Spin until the band above has stored the word. A band only waits on a
// band that is running, so the wait ends; past kSpinLimitNs (a fault in
// the hand-over) the kernel traps, and the call raises, instead of hanging.
constexpr unsigned long long kSpinLimitNs = 20000000000ull;

__device__ __noinline__ unsigned long long wait_word(
    const unsigned long long* p) {
  unsigned long long t0, t1, v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while ((v = load_word(p)) == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    if (t1 - t0 > kSpinLimitNs) __trap();
  }
  return v;
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

template <bool kInit>
struct Band {
  const float* __restrict__ img;
  float* __restrict__ l;
  float* __restrict__ u;
  float* __restrict__ d;
  Pass p;
  int x0, lane;

  // Chunk j's cell of row t and this lane's column: (x0 + t, 1 + 32 j +
  // lane) at g + t * step; rows: the band's rows in range (none when the
  // lane's column is out of range).
  __device__ __forceinline__ int chunk_rows(int j, size_t& g,
                                            long long& step) const {
    const int y = 1 + 32 * j + lane;
    g = p.at(x0, y);
    step = p.inverse ? -(long long)p.cols : (long long)p.cols;
    return y <= p.yhi ? min(32, p.xhi - x0 + 1) : 0;
  }

  // Chunk j into shared memory, one row a copy instruction (cp.async).
  __device__ __forceinline__ void stage(Chunk& c, int j) const {
    size_t g;
    long long step;
    const int n = chunk_rows(j, g, step);
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const long long o = (long long)g + t * step;
      const int i = t * 32 + lane;
      copy4(&c.img[i], img + o);
      if (!kInit) {
        copy4(&c.d[i], d + o);
        copy4(&c.l[i], l + o);
        copy4(&c.u[i], u + o);
      }
    }
  }

  // A finished chunk j back to the planes.
  __device__ __forceinline__ void write_back(const Chunk& c, int j) const {
    size_t g;
    long long step;
    const int n = chunk_rows(j, g, step);
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const long long o = (long long)g + t * step;
      const int i = t * 32 + lane;
      d[o] = c.d[i];
      l[o] = c.l[i];
      u[o] = c.u[i];
    }
  }

  // Planes initialised where no pass updates them: d = 0 on the border,
  // +inf elsewhere; l = u = img.
  __device__ __forceinline__ void init_cell(int x, int y) const {
    const size_t g = p.at(x, y);
    const float v = img[g];
    l[g] = v;
    u[g] = v;
    d[g] = p.border(x, y) ? 0.0f : INFINITY;
  }

  __device__ __forceinline__ void init_row(int x) const {
    for (int y = lane; y < p.cols; y += 32) init_cell(x, y);
  }
};

constexpr int kWarps = 3;  // walker, stager, writer
constexpr int kThreads = 32 * kWarps;

// The block's warps meet here once a super-step (named barrier 1).
__device__ __forceinline__ void meet() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

template <bool kInit>
__global__ void __launch_bounds__(kThreads) mbd_band(
    const float* __restrict__ img, float* __restrict__ l,
    float* __restrict__ u, float* __restrict__ d, Pass p, int nbands,
    unsigned* ticket, unsigned long long* __restrict__ bnd) {
  extern __shared__ float4 smem4[];
  __shared__ int s_band;
  // l and u of the row above chunk j: halo[j % 2][column - 1 - 32 j]
  __shared__ float2 halo[2][32];
  Chunk* ring = reinterpret_cast<Chunk*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    s_band = (int)atomicAdd(ticket, 1u);
    if (s_band == nbands - 1) atomicExch(ticket, 0u);
  }
  __syncthreads();
  const int band = s_band;
  const Band<kInit> b{img, l, u, d, p, 1 + 32 * band, lane};
  const int nchunks = (p.yhi + 31) / 32;
  const int nsup = (p.yhi + 62) / 32;  // steps 0 .. yhi + 30

  if (warp == 1) {
    // The stager: chunk s + 2 and the row above chunk s + 1 during
    // super-step s. Band 0's row above is row 0 (no pass updates it); a
    // later band's is the band above's last row, as its words arrive; each
    // word read is put back to 0 for the next pass.
    unsigned long long* above = bnd + (size_t)band * p.cols;
    auto fetch = [&](int j) {
      const int y = 1 + 32 * j + lane;
      float2 v = make_float2(0.0f, 0.0f);
      if (y <= p.yhi) {
        if (band == 0) {
          const size_t g = p.at(0, y);
          v = kInit ? make_float2(img[g], img[g])
                    : make_float2(l[g], u[g]);
        } else {
          unsigned long long w = load_word(above + y);
          if (w == 0) w = wait_word(above + y);
          store_word(above + y, 0ull);
          v = unpack(w);
        }
      }
      halo[j % 2][lane] = v;
    };
    b.stage(ring[0], 0);
    copy_commit();
    b.stage(ring[1], 1);
    copy_commit();
    fetch(0);
    copy_wait_all_but_one();
    meet();
    for (int s = 0; s < nsup; ++s) {
      if (s + 2 < nchunks) b.stage(ring[(s + 2) % kRing], s + 2);
      copy_commit();
      if (s + 1 < nchunks) fetch(s + 1);
      copy_wait_all_but_one();
      meet();
    }
    return;
  }
  if (warp == 2) {
    // The writer: the cells no pass updates (first pass); then chunk s - 2,
    // finished when super-step s - 1 ended: its last row to the band below
    // (the hand-over words), then the chunk to the planes.
    unsigned long long* below =
        band + 1 < nbands ? bnd + (size_t)(band + 1) * p.cols : nullptr;
    auto finish = [&](int j) {
      const Chunk& c = ring[j % kRing];
      const int y = 1 + 32 * j + lane;
      if (below != nullptr && y <= p.yhi) {
        store_word(below + y,
                   pack(c.l[31 * 32 + lane], c.u[31 * 32 + lane]));
      }
      b.write_back(c, j);
    };
    if (kInit) {
      const int x = b.x0 + lane;
      if (x <= p.xhi) {
        b.init_cell(x, 0);
        b.init_cell(x, p.cols - 2);
        b.init_cell(x, p.cols - 1);
      }
      if (band == 0) b.init_row(0);
      if (band == nbands - 1) {
        b.init_row(p.rows - 2);
        b.init_row(p.rows - 1);
      }
    }
    meet();
    for (int s = 0; s < nsup; ++s) {
      if (s >= 2 && s - 2 < nchunks) finish(s - 2);
      meet();
    }
    for (int j = max(0, nsup - 2); j < nchunks; ++j) finish(j);
    return;
  }

  // The walker: lane r holds row x0 + r; at step k it updates column
  // 1 + k - r, whose cell sits in chunk s (t >= r) or s - 1 (t < r) of
  // super-step s = k / 32, t = k % 32, at row r, column (t - r) & 31. The
  // chunks are addressed as word offsets into shared memory, and a step
  // has no branch: a lane off the band's cells computes and keeps nothing.
  const int x = b.x0 + lane;
  const bool row_on = x <= p.xhi;
  float my_l = 0.0f, my_u = 0.0f;  // neighbour 2: the lane's last cell
  if (row_on) {  // column 0, which no pass updates
    const size_t g = p.at(x, 0);
    my_l = kInit ? img[g] : l[g];
    my_u = kInit ? img[g] : u[g];
  }
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int kChunk = 4 * kTile;  // img, d, l, u
  meet();
  for (int s = 0; s < nsup; ++s) {
    const int cur = (s % kRing) * kChunk + lane * 32;
    const int prev = ((s + kRing - 1) % kRing) * kChunk + lane * 32;
    const float2* row_above = halo[s % 2];
    const int off0 = 32 * s - lane;  // column - 1 at step 0
    auto at = [&](int t) {
      return (t >= lane ? cur : prev) + ((t - lane) & 31);
    };
    auto on_at = [&](int t) {
      return row_on && (unsigned)(off0 + t) < (unsigned)p.yhi;
    };
    int o = at(0);
    float ix = sm[o];
    float dd = kInit ? INFINITY : sm[o + kTile];
    float ol = kInit ? ix : sm[o + 2 * kTile];
    float ou = kInit ? ix : sm[o + 3 * kTile];
    float2 above = row_above[0];
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      // the next step's cell and row above, read before this step's
      // stores (no lane writes a cell another lane reads in the next step)
      const int no = t < 31 ? at(t + 1) : o;
      const float nix = sm[no];
      const float ndd = kInit ? INFINITY : sm[no + kTile];
      const float nol = kInit ? nix : sm[no + 2 * kTile];
      const float nou = kInit ? nix : sm[no + 3 * kTile];
      const float2 nabove = row_above[t < 31 ? t + 1 : t];
      float up_l = __shfl_up_sync(PT_FULL, my_l, 1);
      float up_u = __shfl_up_sync(PT_FULL, my_u, 1);
      up_l = lane == 0 ? above.x : up_l;
      up_u = lane == 0 ? above.y : up_u;
      const float hi1 = fmaxf(up_u, ix), lo1 = fminf(up_l, ix);
      const float hi2 = fmaxf(my_u, ix), lo2 = fminf(my_l, ix);
      const float b1 = __fsub_rn(hi1, lo1), b2 = __fsub_rn(hi2, lo2);
      const bool keep = dd <= b1 && dd <= b2;
      const bool use1 = !keep && b1 < dd && b1 <= b2;
      const float nd = keep ? dd : (use1 ? b1 : b2);
      const float nl = keep ? ol : (use1 ? lo1 : lo2);
      const float nu = keep ? ou : (use1 ? hi1 : hi2);
      if (on_at(t)) {
        sm[o + kTile] = nd;
        sm[o + 2 * kTile] = nl;
        sm[o + 3 * kTile] = nu;
        my_l = nl;
        my_u = nu;
      }
      o = no;
      ix = nix;
      dd = ndd;
      ol = nol;
      ou = nou;
      above = nabove;
    }
    meet();
  }
}

}  // namespace

// img, l, u, d: (rows, cols) f32 row-major. init: l, u, d are set by the
// first pass (rows, cols >= 4); else they hold their initial values.
// ticket: one zero int; bnd: ceil((rows - 2) / 32) * cols zero words; both
// are zero again when the call's launches end.
PT_EXPORT int pt_mbd(const float* img, float* l, float* u, float* d, int rows,
                     int cols, int init, unsigned* ticket,
                     unsigned long long* bnd, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (init && (rows < 4 || cols < 4)) return (int)cudaErrorInvalidValue;
  cudaError_t err = pt_opt_in_smem(mbd_band<true>, kSmem, g_smem_init);
  if (err == cudaSuccess) {
    err = pt_opt_in_smem(mbd_band<false>, kSmem, g_smem_pass);
  }
  if (err != cudaSuccess) return (int)err;
  for (int it = 0; it < 3; ++it) {
    const int inverse = it % 2 == 0;
    const Pass p{rows, cols, rows - 2 - inverse, cols - 2 - inverse,
                 inverse};
    if (p.xhi < 1 || p.yhi < 1) continue;
    const int nbands = (p.xhi + 31) / 32;
    if (it == 0 && init) {
      mbd_band<true><<<nbands, kThreads, kSmem, st>>>(
          img, l, u, d, p, nbands, ticket, bnd);
    } else {
      mbd_band<false><<<nbands, kThreads, kSmem, st>>>(
          img, l, u, d, p, nbands, ticket, bnd);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
