#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (patolette_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card, its power limit, the torch / CUDA / nvcc versions;
  2. build: compiles the kernels from this checkout's csrc/ (nvcc, sm_90a);
  3. kernels: each kernel against its plain-PyTorch version on the card at
     the main paths' shapes (max deviation, label agreement), timed with
     CUDA events beside the plain version, a PyTorch library call where one
     computes the same function, and the least time the card could take;
     K5's u8 and u16 tables must also equal K3's map of all 2^24 codes,
     as must K5's tables at the adversarial palettes and on a mesh rank's
     quarter slice (kernel-k5-adversarial), with the centres each warp's
     pruned scan listed (mean, max; K3's on the 4K synthetic image and
     random pixels too, in K3's sorted layout of 8192-point tiles and, as
     a sweep, in 4096-point tiles and the linear layout, each timed) and
     K5's brick layout timed beside the linear one; K3 bit for bit on its edge cases
     (kernel-k3-cases: 1x1, 8x1, 1x8, 5x3, one centre, duplicates and
     exact ties, invalid slots, NaN and +-inf coordinates, non-finite
     centres, a constant image, a ragged last tile); K8 at the 4K shape at
     each of its group sizes (the sweep behind the wrapper's choice, each
     bit for bit) and on its cases (kernel-k8-cases: one and two entries,
     the tiled walk at 4096 entries, one lane at 5x3, lanes of one step,
     1x1, 8x1, 1x8, n < 32, a short last lane, duplicated entries,
     invalid slots, NaN and +-inf pixels, inf x 0, non-finite entries;
     every group size and the wrapper, twice, bit for bit); K7, the whole
     visit order, bit for bit and a bijection at 4K, at the 100 MP call's
     strip and at the thin and tiny shapes of K7_SHAPES (kernel-k7-cases);
     K10 must equal its plain version bit for bit in every target, input
     kind and working space, and on all 2^24 codes, and its pow_exact must
     equal libdevice's pow on all 2^32 f32 inputs of each of its seven
     exponents (kernel-k10-pow, with the fallback rates); K6 on a palette's
     2^24 table and on its second quarter must equal its plain version in
     header and words and decode back to the table, and must flag an
     alternating table; K6's v1 and u16 v2 formats on K5's 256- and
     1024-colour tables and on crafted tables (one alternating 128-block;
     the alternating table, over v1's run cap) likewise, and all three
     formats on a table whose runs cross every group boundary and on one
     that ends in an overflowing 128-block (kernel-k6-cases); K4 with a
     reduction between its two halves must match its plain version as
     without one; K11 (the GQ DP) must equal its plain version in prefix,
     level costs, cut rows and chains, and give gq_device the same cuts
     and k, on the 4K image's bucket moments (p = 1, 2, 12), the
     2048x2048 image's at every p of 1 .. 12, random moments, empty
     buckets, all mass in one bucket, NaN and +-inf buckets, and the
     adversarial moments of kernels.gq.adversarial_moments at b = 1, 2,
     33, 512 and 1023, and at b <= 512 at each cluster size of its sweep
     (kernel-k11-cases; kernel-k11-sweep: each cluster size's event
     time). K1 is timed at GQ's 512x11, the palette's 256x4 and the
     LQ loop's 16x11 and 12x4 (id S: no candidate), K4 at P = 256 and
     P_LARGE, K2 at the random case and on the inputs of the LQ loop's own
     call at its median member share (logged from one 4K e2e call) (their
     per-launch device times come in the split phase, 10);
     K1, K2, K4 and K9 also run adversarial inputs
     (kernel-adversarial lines: K1 equal, sorted and out-of-range ids,
     ragged and tiny N, S = 1, F = 1 and 32, segment tiles, the in-launch
     and the second-launch sums bit for bit; K2 C = 1, C = 12, dead slots,
     a flat cluster, every member in one bucket, buckets equal and reruns
     the same bits; K4 at P = 1, every sample nearest one centre, zero
     weights, exact ties, NaN and +-inf samples with slot 0 invalid, inf x
     0, non-finite centres (also tiled); K9 d, l and u bit for bit at
     3x50, 50x3, 2x2,
     1x1, 4x4, 31x31, 33x4000, 4000x33, 540x3840, 3840x2160 and on a
     constant and an 8-level image);
  3b. pull: the table pull (ops/lut.py::pull_lut) once for each branch
     (u8 v2; v2 overflowed, v1; v1 over its cap, raw; u16 v2; u16 v2
     overflowed, raw), each equal to the table bit for bit and launching
     the K6 kernels of its branch; then the raw copy against pull_lut on
     K5's two tables, in turns, medians, with the decode's time into a
     fresh and into a pre-faulted host buffer;
  4. e2e: quantize() of a 4K float32 image to 256 colours with 32 KMeans
     iterations and no dither or saliency (K1-K4 and K10 must launch, two
     runs must agree bit for bit, peak device bytes per pixel at or below
     the pipeline's BYTES_PER_PIXEL), then the same pixels as uint8, which
     take the sampled LUT route's fused program (K5, K11, K1, K2, K4, K10
     must launch and K3 must not, two runs must agree bit for bit, CIELuv
     MSE within 1% of the float32 call's; the table comes back through
     K6's v2 words); one more call runs the program under
     torch.cuda.set_sync_debug_mode("error") from the sample upload to the
     first pull (any host read there fails the phase), and one staged
     call (PATOLETTE_NO_FUSED_LUT: the host f64 DP) stands beside it;
  4b. e2e-u8-ramp: a 4K uint8 grey ramp of 256 levels on the same route,
     whose table overflows v2 and comes back through K6's v1 words (K6 v2
     and v1 must launch once each, K3 must not; the map equal to K3's
     direct map against the program's palette);
  5. e2e-default: the library's default call on the same image (MBD
     saliency, weighted palette, Riemersma dither; K7, K8, K9, K1, K2, K4
     and K10 must launch, two runs must agree bit for bit, the CIELuv MSE
     must be under half the 216-colour cube's dithered the same way, the
     dither must not lose to the undithered map on 8x8 block means, peak
     bytes per pixel at or below BYTES_PER_PIXEL_SALIENCY_OR_DITHER),
     float32 and uint8;
  5b. e2e-one-shot and e2e-one-shot-default: the one-shot route at
     2048x2048 (2^22 pixels), 256 colours, undithered with 32 KMeans
     iterations and the library's default call: K11, K1, K2, K4, K10 and
     K3 (or K9, K7, K8) must launch, the palette core runs under
     torch.cuda.set_sync_debug_mode("error") (any host read in it fails
     the phase), bit-identical reruns, peak bytes per pixel at or below
     the route's ONE_SHOT_BYTES_PER_PIXEL(_SALIENCY_OR_DITHER), the
     device-budget guard's model for it, the CIELuv MSE within
     ONE_SHOT_MSE_RATIO of the resident route's (PATOLETTE_NO_ONE_SHOT)
     on the same call, the dither checks on the default call; the host
     syncs of a whole call are counted (sync debug mode "warn");
  5c. api: the JAX package's last public functions at 3840x2160, one line
     a check with its wall time: get_weights against get_weights_planar
     and mbd against K9's wrapper, bit for bit (K9, K10 launched);
     riemersma_dither on (N, 3) working rows against
     riemersma_dither_planar, bit for bit (K10 for the image and the
     palette, K7 and K8 once each); cieluv_to_srgb and ictcp_to_srgb of
     K10's working image against the same glue on the CPU (1e-4) and back
     to the input; pca_from_cov on 2^20 covariances (a degenerate one in
     64) within 1e-6 of device="cpu";
  5d. e2e-image-fused-lut: the opt-in full-image fused LUT route
     (PATOLETTE_FUSED_IMAGE_LUT=1) on the 4K uint8 image with saliency,
     undithered: K9, K10, K11, K1, K2, K4, K5, K6 must launch and K3 must
     not, bit-identical reruns, peak device memory within the route's
     footprint model (pipeline._image_lut_bytes), the map equal to K3's
     direct map against the same palette;
  6. e2e-headline: bench.py's call through the port (10000x10000 uint8,
     256 colours, 25 KMeans iterations, ICtCp, no dither or saliency): one
     warm call, best of 3, the launch and repeat checks (K11 among them),
     CIELuv MSE on a
     fixed 1M-pixel subset, peak device memory within 10% of the 4K uint8
     call's (nothing on the device grows with N), the fused program's
     palette bit for bit palette_pipeline_device's on the same samples
     (S11: KMeans on the LQ sample); then one call at 1024
     colours, whose table is u16 (K5 and K6's u16 v2 must launch, K3 must
     not, the MSE must be below the 256-colour call's); K5 on both calls'
     own palettes equal to its plain version and to K3 on all 2^24 codes
     (kernel-k5-headline);
  7. the streamed route, its palette by the sampled route's program
     without the table: e2e-strip-dither, the 4K float32 image dithered
     without saliency on 2 row strips (K7, K8, K10, K11, K1, K2, K4 must
     launch, K3 and K9 must not, bit-identical reruns, the dither checks of
     e2e-default); e2e-strip-headline, the 100 MP uint8 image dithered on
     6 strips through the packed feed, then a 7680x4320 uint8 image on 2
     (peak device memory of the 100 MP call at most 1.1x the 33 MP
     call's); e2e-over-budget, the 4K undithered call under a lowered
     device budget (its map equal to K3's whole-image map against the
     same palette, its CIELuv MSE within 1% of the resident call's);
  8. the multi-device route, quantize(mesh=), its palette by
     quantize_palette_sharded (K11 on the reduced moments, launched on
     every call): e2e-mesh-u8, -f32, -default
     and -headline with one rank (a world-1 NCCL group in this process on
     cuda:0): the 4K uint8 call on the sharded table (K10, K5, K6 must
     launch, K3 must not; the assembled table equal to the single-device
     K5 table for its palette, the map equal to the host map through it),
     the 4K float32 and default calls, the 100 MP uint8 image; each with
     the launch, rerun and lap checks and its CIELuv MSE within
     MESH_MSE_RATIO of the single-device route's; e2e-mesh-palette:
     quantize_palette_distributed (palette_pipeline_device(mesh=): K11 on
     the reduced moments) without draws equal to palette_pipeline_device
     without a mesh, bit for bit, then its 32-iteration call with draws
     and dither_distributed, timed, K11 launched; then e2e-mesh-4: four
     processes (this script with --mesh-worker) sharing cuda:0 over gloo,
     the 4K uint8 and default calls: every rank's palette, map and table
     identical, K6 launched on every rank, the table equal to the
     single-device K5 table, the uint8 MSE within MESH_MSE_RATIO of world
     1's, the default call's dither checks and its MSE within
     MESH4_DEFAULT_RATIO of world 1's at each seed of MESH4_SEEDS (the
     call without saliency is reported beside them), and one
     quantize_palette_distributed + dither_distributed call a rank: the
     palette the same bits on every rank, each rank's maps its rows of the
     gathered whole, the MSE within MESH4_PALETTE_RATIO of world 1's
     (MESH4_DEFAULT_RATIO dithered);
  9. golden: the 96x64 inputs against tests/golden/quantize_golden.npz;
 10. split: K1, K2, K4, K9, K3, K8, K7, K5, K6, K10 and K11 alone at the
     kernels phase's shapes (K9 also at a mesh-4 rank's strip), each launch's
     device time (torch.profiler) and the enqueue rate, index_add_ beside
     K1 and, on
     K2's keys and precomputed features, beside K2, and K11 at each
     cluster size of its sweep; last, because a traced process pays
     CUPTI's cost on every later launch.
With ``--routes`` (a measurement, not a check) it then times the sampled
LUT route against the resident route (direct map) at 4, 8.3 and 33 MP
uint8, and the host map against plain torch CPU ops and a gather on the
card at 100 MP.
With ``--split`` it runs only the device, build and split phases, and
with ``--root DIR`` on the kernels of the checkout at DIR (a parent's,
unpacked with git archive), so two versions can be timed in turns in one
call.
With ``--laps`` it runs only the device, build and laps phases (the
uint8 LUT call's, the default call's, the headline call's, the 100 MP
strip dither's and the two 2048x2048 calls' walls and laps, several
rounds), with ``--root DIR`` too.
With ``--spans`` it runs only the device, build and spans phases: the
benchmark cells' three calls, their walls untraced and traced, and from
the profiler's trace each stage span checked against the laps and what the
spans hold (the palette core's idle and device time, the LQ loop's
submissions, the host waits); with ``--root DIR`` too.
With ``--lq-graph`` it runs only the device, build and lq-graph phases:
the benchmark cells' calls with the LQ loop's graph (walls, palette-core
laps, peak allocated and reserved memory, LQ_GRAPH), then the replayed loop
held bit for bit to the eager one on every cell's inputs, two under 2^18
pixels and a 1024-colour call's, under sync debug mode "error".
With ``--profile`` the e2e phases (and e2e-mesh-u8) also trace one call each with
torch.profiler (device busy share, kernels by device time). With ``--out
DIR`` the ptxas report, the profiler tables and every JSON line
(smoke.jsonl) are written to DIR. Then
the nvidia-smi line, the kernels line and, last, the ok line. Any failed
check raises and the script exits non-zero; without a CUDA device (or
without the package beside it) it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
DEV = "cuda"
# The main paths' shapes: a 4K image, 2^18 palette samples, 256 colours,
# and the palette size above K4's shared-memory table.
W, H = 3840, 2160
N_SAMPLES = 1 << 18
P_LARGE = 8192
# bench.py's headline image, and the sizes the --routes table compares.
HEADLINE_W, HEADLINE_H = 10000, 10000
# the uint8 image the strip dither's 100 MP peak is held against: 2 strips
# of about the size of the 100 MP call's 6
STRIP_33MP_W, STRIP_33MP_H = 7680, 4320
ROUTE_SHAPES = ((2048, 2048), (3840, 2160), (7680, 4320))
# the one-shot route's largest image: exactly 2^22 pixels
ONE_SHOT_W, ONE_SHOT_H = 2048, 2048


def _out_dir():
    """The directory given with ``--out``, or None."""
    args = sys.argv[1:]
    if "--out" in args and args.index("--out") + 1 < len(args):
        out = pathlib.Path(args[args.index("--out") + 1])
        out.mkdir(parents=True, exist_ok=True)
        return out
    return None

# H100 SXM published peaks (dense): HBM bytes/s, f32 and f64 non-tensor
# FLOP/s (f64 at half the f32 rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 33.5e12
# f32 instructions a second (132 SMs x 128 lanes x 1.98 GHz): the rate of
# operations that cannot fuse into an FMA, half the FMA-counted peak
PEAK_F32_INSTR = 33.5e12
# Dependent-issue latencies in cycles that K8's chain count assumes: an f32
# operation, a warp shuffle, a shared-memory load (Hopper, the same as on
# Ampere; not measured here).
LAT_F32, LAT_SHFL, LAT_LDS = 4, 23, 23


def emit(obj):
    """Print one JSON line; with ``--out DIR`` also append it to
    DIR/smoke.jsonl (the end of a long output may be all a caller keeps)."""
    line = json.dumps(obj)
    print(line, flush=True)
    out = _out_dir()
    if out is not None:
        with open(out / "smoke.jsonl", "a") as f:
            f.write(line + "\n")


def bound_ms(nbytes, flops, f64_flops=0):
    """Least time for the work: the larger of bytes over the memory rate
    and the operations over their type's rate (f32, f64); also which one
    bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOPS + f64_flops / PEAK_F64_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def enqueue_ms(fn, calls=100):
    """ms a call of ``calls`` back-to-back calls between two CUDA events:
    the host's enqueue rate where it is slower than the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def time_ms(fn, reps=10, warm=2):
    """Median ms of ``reps`` warm runs, each bracketed by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _agreement(a, b):
    """Share of equal entries, from an exact integer count."""
    return 1.0 - int((a != b).sum()) / max(1, a.numel())


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def phase_device(torch):
    nvcc = subprocess.run(["bash", "-lc", "nvcc --version | tail -n 2"],
                          capture_output=True, text=True, timeout=60)
    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_line(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": " ".join(nvcc.stdout.split()),
        "python": sys.version.split()[0],
    }
    emit(info)
    return info


def phase_build():
    from patolette_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    log = (build.BUILD_ROOT / build.source_hash() / "build.log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    out_dir = _out_dir()
    if out_dir is not None and log.exists():
        (out_dir / "ptxas.log").write_text(log.read_text())
    emit({"phase": "build", "seconds": round(secs, 3),
          "library": str(build.build()),
          "ptxas": ptxas[:16]})


def _working_pixels(torch, n, seed):
    """n pixels of an image-like ICtCp distribution on the card."""
    from patolette_tpu_torch.ops import colorspace as cs

    g = torch.Generator(device=DEV).manual_seed(seed)
    base = torch.rand((n, 3), generator=g, device=DEV)
    return cs.srgb_to_working(base, 2).contiguous()


def _kernel_name(key):
    """A profiler kernel name without its return type, namespace, template
    and arguments: ``void (anonymous namespace)::f<true>(float*)`` ->
    ``f``."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[(<]", name, maxsplit=1)[0].strip() or key


def launch_split(torch, fn, reps=20):
    """Device time of each kernel a wrapper call launches (torch.profiler's
    CUDA activity, averaged over ``reps`` warm calls): {kernel: [launches
    a call, ms a call]}, and the kernels' sum; None when the profiler shows
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")) or \
                e.key.startswith("Activity Buffer"):
            continue
        name = _kernel_name(e.key)
        launches, ms = split.get(name, (0.0, 0.0))
        split[name] = (launches + e.count / reps,
                       ms + e.self_device_time_total / 1e3 / reps)
    if not split:
        return None
    return {"kernels": {k: [v[0], v[1]] for k, v in sorted(split.items())},
            "device_ms": sum(v[1] for v in split.values())}


# K1's rows: (S, F, ids drawn from [0, hi)): GQ's buckets, the palette's
# centres, and the LQ loop's candidate passes (pass 2 every round at S =
# 2 lq_batch_splits = 16, pass 1 on the first call at S = 12), where id S
# means "no candidate" (out of range, dropped).
K1_SHAPES = ((512, 11, 512), (256, 4, 256), (16, 11, 17), (12, 4, 13))


def _k1_feats(torch, x, f):
    from patolette_tpu_torch.ops import moments as M

    n = x.shape[0]
    if f == 11:
        return M.moment_features(x, shift=x.mean(0)).contiguous()
    return torch.cat([torch.ones((n, 1), device=DEV), x], 1).contiguous()


def _k1_check(torch, feats, ids, s, what):
    """K1 against its plain version (a few ulps of sum |x|) and itself."""
    from patolette_tpu_torch.kernels.segment import (segment_sum,
                                                     segment_sum_plain)

    got = segment_sum(feats, ids, s)
    twin = segment_sum_plain(feats, ids, s)
    again = segment_sum(feats, ids, s)
    torch.cuda.synchronize()
    check(got.shape == (s, feats.shape[1]), f"K1 {what}: shape")
    err = float((got - twin).abs().max())
    # f32 sums of up to n terms in two orders: a few ulps of sum |x|
    tol = 1e-5 * float(segment_sum_plain(feats.abs(), ids, s).max())
    check(err <= tol, f"K1 {what} deviates {err} > {tol}")
    check(torch.equal(got, again), f"K1 {what} not deterministic")
    return got, err, tol


def kernel_k1(torch, rows):
    from patolette_tpu_torch.kernels.segment import (segment_sum,
                                                     segment_sum_plain)

    n = N_SAMPLES
    x = _working_pixels(torch, n, 1)
    for s, f, hi in K1_SHAPES:
        g = torch.Generator(device=DEV).manual_seed(s)
        ids = torch.randint(0, hi, (n,), generator=g, device=DEV,
                            dtype=torch.int32)
        feats = _k1_feats(torch, x, f)
        _, err, tol = _k1_check(torch, feats, ids, s, f"({s},{f})")
        ms = time_ms(lambda: segment_sum(feats, ids, s))
        plain = time_ms(lambda: segment_sum_plain(feats, ids, s))
        idsl = ids.long()
        keep = ids < s
        idsk, featsk = idsl[keep], feats[keep].contiguous()
        def library():
            return torch.zeros((s, f), device=DEV).index_add_(0, idsk,
                                                              featsk)

        lib = time_ms(library)
        members = int(keep.sum())
        # every id read; the rows of the pixels that have a segment
        b, by = bound_ms(n * 4 + members * f * 4 + s * f * 4, members * f)
        rows.append(dict(name=f"segment_sum[{s}x{f}]", shape=[n, s, f],
                         max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b, bound_by=by))


def kernel_k1_adversarial(torch):
    """K1 on inputs built to break a grouped accumulation: every id equal,
    sorted ids, every id out of range, ragged and tiny N, S = 1, F = 1 and
    32, S = 4096 (segment tiles); and the partials summed in the launch or
    by a second one must give the same bits."""
    from patolette_tpu_torch.kernels import segment

    n = N_SAMPLES
    x = _working_pixels(torch, n, 40)
    g = torch.Generator(device=DEV).manual_seed(41)

    def ids_in(hi, size=n):
        return torch.randint(0, hi, (size,), generator=g, device=DEV,
                             dtype=torch.int32)

    def feats_of(size, f):
        if f in (4, 11):
            return _k1_feats(torch, x[:size], f)
        return torch.rand((size, f), generator=g, device=DEV)

    cases = {
        "all_equal": (feats_of(n, 11), torch.full((n,), 3, device=DEV,
                                                  dtype=torch.int32), 16),
        "sorted": (feats_of(n, 11), ids_in(512).sort().values, 512),
        "all_out_of_range": (feats_of(n, 11),
                             torch.where(ids_in(2) == 0, 16, -1)
                             .to(torch.int32), 16),
        "ragged_n": (feats_of(n - 17, 11), ids_in(17, n - 17), 16),
        "n_1": (feats_of(1, 11), ids_in(16, 1), 16),
        "s_1": (feats_of(n, 11), ids_in(2), 1),
        "f_1": (feats_of(n, 1), ids_in(17), 16),
        "f_32": (feats_of(n, 32), ids_in(257), 256),
        "s_4096_tiles": (feats_of(n, 11), ids_in(4096), 4096),
    }
    out = {"phase": "kernel-adversarial", "kernel": "segment_sum"}
    for name, (feats, ids, s) in cases.items():
        got, err, tol = _k1_check(torch, feats, ids, s, name)
        if name == "all_out_of_range":
            check(not bool(got.any()), "K1: out-of-range ids added")
        out[name] = {"n": ids.shape[0], "s": s, "f": feats.shape[1],
                     "max_abs_err": err, "tol": tol}
    # the in-launch sum and the second launch sum in the same order
    fuse = segment.FUSE_MAX_LEN
    for s, f, hi in K1_SHAPES[1:]:
        feats, ids = feats_of(n, f), ids_in(hi)
        fused = segment.segment_sum(feats, ids, s)
        segment.FUSE_MAX_LEN = 0
        try:
            second = segment.segment_sum(feats, ids, s)
        finally:
            segment.FUSE_MAX_LEN = fuse
        torch.cuda.synchronize()
        check(torch.equal(fused, second),
              f"K1 ({s},{f}): fused and two-launch sums differ")
        out[f"fused_equals_two_launch[{s}x{f}]"] = True
    emit(out)


def _k2_tab(torch, x, wm, cand, c):
    """The LQ loop's (C, 8) candidate table for these members: weighted
    means, principal axes, the +-4 sigma range and its binning scale."""
    from patolette_tpu_torch.ops import eigen3
    from patolette_tpu_torch.ops import moments as M

    m1 = M.segment_matmul(torch.cat([wm[:, None], wm[:, None] * x], 1)
                          .contiguous(), cand, c)
    mu = m1[:, 1:4] / m1[:, 0:1].clamp_min(1e-30)
    xs = x - torch.cat([mu, torch.zeros((1, 3), device=DEV)])[cand.long()]
    mom = M.segment_moments(xs, cand, c, weights=wm)
    axis, evals = eigen3.principal_axis(M.moments_cov(mom))
    pmax = 4.0 * evals[:, 2].clamp_min(0.0).sqrt()
    scale = M.bucket_scale(2.0 * pmax)
    return torch.cat([mu, axis, -pmax[:, None], scale[:, None]],
                     1).contiguous()


_LQ_LOOP = {}


def lq_loop_inputs(torch):
    """K2's calls in one 4K e2e call (float32, 256 colours, ICtCp): each
    call's member share (pixels with a candidate, of N), and a copy of the
    inputs of the call at the median share. Once a process."""
    if _LQ_LOOP:
        return _LQ_LOOP
    import patolette_tpu_torch as pt
    from patolette_tpu_torch.models import local_q

    seen = []
    real = local_q.lq_candidates

    def spy(colors, wm, cand, tab, nb):
        c = tab.shape[0]
        share = int((cand < c).sum()) / cand.shape[0]
        seen.append((share, [t.clone() for t in (colors, wm, cand, tab)],
                     nb))
        return real(colors, wm, cand, tab, nb)

    # the spy reads the host, which a graph's capture forbids: the eager
    # loop runs
    graphed = local_q.lq_quantize
    local_q.lq_candidates = spy
    local_q.lq_quantize = local_q.lq_loop
    try:
        ok, _, _, msg = pt.quantize(
            W, H, synth_image_f32(W, H), 256, dither=False, tile_size=0,
            kmeans_niter=32, color_space=pt.ColorSpace_ICtCp, device=DEV)
    finally:
        local_q.lq_candidates = real
        local_q.lq_quantize = graphed
    check(ok, f"quantize failed: {msg}")
    shares = [s for s, _, _ in seen]
    share, args, nb = sorted(seen, key=lambda e: e[0])[len(seen) // 2]
    # kept on the host: the e2e phases' peak device memory counts only
    # what their calls hold
    _LQ_LOOP.update(shares=shares, median=share,
                    args=(*(a.cpu() for a in args), nb),
                    c=[int(a[3].shape[0]) for _, a, _ in seen])
    return _LQ_LOOP


def k2_cases(torch):
    """K2's inputs: the random case (16 of every 17 pixels members), the
    LQ loop's own call at its median member share, C = 1, C = 12, dead
    slots (4 of 16 slots without pixels), a flat cluster (scale 0), and
    every member in one bucket (every lane of a step one key)."""
    n, nb = N_SAMPLES, 512
    x = _working_pixels(torch, n, 2)
    g = torch.Generator(device=DEV).manual_seed(3)

    def case(c, hi, flat=()):
        # ids drawn from [0, hi]; hi and above: no candidate (id C)
        cand = torch.randint(0, hi + 1, (n,), generator=g, device=DEV,
                             dtype=torch.int32)
        cand = torch.where(cand >= hi, c, cand).to(torch.int32)
        wm = torch.where(cand < c, 1.0, 0.0).to(torch.float32)
        tab = _k2_tab(torch, x, wm.contiguous(), cand, c)
        for j in flat:
            tab[j, 7] = 0.0
        return x, wm.contiguous(), cand, tab.contiguous(), nb

    one_x = x[:1].expand(n, 3).contiguous()
    one_cand = torch.zeros((n,), dtype=torch.int32, device=DEV)
    one_wm = torch.ones((n,), dtype=torch.float32, device=DEV)
    return {
        "random": case(16, 16),
        "lq_loop_median": tuple(a.to(DEV) if torch.is_tensor(a) else a
                                for a in lq_loop_inputs(torch)["args"]),
        "c_1": case(1, 1),
        "c_12": case(12, 12),
        "dead_slots": case(16, 12),
        "flat_cluster": case(16, 16, flat=(5,)),
        "one_bucket": (one_x, one_wm, one_cand,
                       _k2_tab(torch, one_x, one_wm, one_cand, 1), nb),
    }


def _k2_check(torch, args, what):
    """K2 against its plain version: buckets equal, the table within 1e-5
    of its largest magnitude (bf16-rounded features summed in f32 in two
    orders), a rerun the same bits."""
    from patolette_tpu_torch.kernels.lq import (lq_candidates,
                                                lq_candidates_plain)

    got, bucket = lq_candidates(*args)
    twin, tbucket = lq_candidates_plain(*args)
    again, abucket = lq_candidates(*args)
    torch.cuda.synchronize()
    err = float((got - twin).abs().max())
    tol = 1e-5 * float(twin.abs().max())
    check(torch.equal(bucket, tbucket), f"K2 {what}: buckets differ")
    check(err <= tol, f"K2 {what} deviates {err} > {tol}")
    check(torch.equal(got, again) and torch.equal(bucket, abucket),
          f"K2 {what} not deterministic")
    return err, tol


def _k2_bound(args, partial_bytes=0):
    """K2's least time: every pixel's candidate read and bucket written (8
    B), a member's colour and weight read (16 B), the table read and
    written; 24 operations a member. ``partial_bytes``: the design's
    partial tables, written and read."""
    colors, wm, cand, tab, nb = args
    n, c = cand.shape[0], tab.shape[0]
    members = int((cand < c).sum())
    return bound_ms(n * 8 + members * 16 + c * 32 + c * nb * 20
                    + 2 * partial_bytes, members * 24)


def kernel_k2(torch, rows):
    from patolette_tpu_torch.kernels import lq
    from patolette_tpu_torch.kernels.lq import (lq_candidates,
                                                lq_candidates_plain)

    out = {"phase": "kernel-adversarial", "kernel": "lq_candidates"}
    for name, args in k2_cases(torch).items():
        err, tol = _k2_check(torch, args, name)
        n, c = args[2].shape[0], args[3].shape[0]
        out[name] = {"n": n, "c": c, "members": int((args[2] < c).sum()),
                     "max_abs_err": err, "tol": tol}
        if name not in ("random", "lq_loop_median"):
            continue
        ms = time_ms(lambda: lq_candidates(*args))
        plain = time_ms(lambda: lq_candidates_plain(*args), reps=10, warm=1)
        b, by = _k2_bound(args)
        bp, _ = _k2_bound(args, lq.partial_bytes(args[0].device, n, c,
                                                 args[4]))
        rows.append(dict(
            name="lq_candidates" + ("" if name == "random" else "[loop]"),
            shape=[n, c, args[4]], member_share=out[name]["members"] / n,
            max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
            library_ms=None, bound_ms=b, bound_by=by,
            bound_with_partials_ms=bp))
    loop = lq_loop_inputs(torch)
    out["lq_loop_shares"] = loop["shares"]
    out["lq_loop_c"] = loop["c"]
    emit(out)


def _k3_inputs(torch, kind):
    """K3's 4K inputs: ICtCp planes (random pixels, or bench.py's synthetic
    image as the direct map gets it) and 256 centres drawn from them."""
    if kind == "image":
        from patolette_tpu_torch.kernels.colorspace import color_convert

        chans = color_convert(torch.from_numpy(synth_image_f32(W, H)).to(DEV),
                              2, "ictcp")
        x = torch.stack(chans, 1)
    else:
        x = _working_pixels(torch, W * H, 4)
        chans = tuple(x[:, k].contiguous() for k in range(3))
    g = torch.Generator(device=DEV).manual_seed(5)
    centers = x[torch.randint(0, W * H, (256,), generator=g,
                              device=DEV)].contiguous()
    valid = torch.ones(256, dtype=torch.bool, device=DEV)
    valid[-3:] = False
    return x, chans, centers, valid


# nearest_probe's layouts timed and counted beside K3's own ("sorted",
# tiles of 8192 points): tiles of 4096, and the linear layout (runs of
# image rows, as K5 scans points off the grid)
K3_LAYOUTS = ("sorted", "sorted4096", "linear")


def kernel_k3(torch, rows):
    """K3 at the 4K direct map's shape against its plain version (random
    pixels and bench.py's synthetic image); on both, for each of
    K3_LAYOUTS, the centres each warp's pruned scan listed (mean, max) and
    the probe's time (the sweep that fixed K3's tile), its labels equal to
    K3's."""
    from patolette_tpu_torch.kernels.assign import (assign_planar,
                                                    assign_planar_plain)
    from patolette_tpu_torch.kernels.lut import nearest_probe

    candidates, layouts, twins = {}, {}, {}
    for kind in ("image", "random"):
        x, chans, centers, valid = _k3_inputs(torch, kind)
        got = assign_planar(chans, centers, valid)
        again = assign_planar(chans, centers, valid)
        twin = assign_planar_plain(chans, centers, valid)
        torch.cuda.synchronize()
        check(torch.equal(got, twin), f"K3 {kind} differs from its plain "
              f"version at {int((got != twin).sum())} pixels")
        check(torch.equal(got, again), f"K3 {kind} not deterministic")
        twins[kind] = int((got != twin).sum())
        layouts[kind] = {}
        for layout in K3_LAYOUTS:
            labels, counts = nearest_probe(chans, centers, valid, layout)
            torch.cuda.synchronize()
            check(torch.equal(labels, got),
                  f"K3 {kind}: the {layout} probe differs")
            layouts[kind][layout] = dict(
                candidates=_k5_candidates(torch, counts),
                ms=time_ms(lambda: nearest_probe(chans, centers, valid,
                                                 layout)))
        candidates[kind] = layouts[kind]["sorted"]["candidates"]
    n, p = W * H, 256
    ms = time_ms(lambda: assign_planar(chans, centers, valid))
    plain = time_ms(lambda: assign_planar_plain(chans, centers, valid),
                    reps=10, warm=1)
    cv = centers[valid]
    lib = time_ms(lambda: torch.cdist(x, cv).argmin(1), reps=10, warm=1)
    # the pruned scan's least time: pixels read, labels written; beside it
    # the brute force's 7 unfused operations per (pixel, valid centre) at
    # the f32 instruction rate
    b, by = bound_ms(n * 12 + p * 16 + n * 4, 0)
    brute = n * int(valid.sum()) * 7 / PEAK_F32_INSTR * 1e3
    rows.append(dict(name="assign_planar", shape=[n, p], label_agreement=1.0,
                     max_abs_err=float(twins["random"]), ms=ms,
                     plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
                     brute_force_operations_ms=brute,
                     candidates=candidates, layouts=layouts))


def _k3_case(torch, name):
    """(planes, centres, valid) of one of K3_CASES, on the card."""
    import numpy as np

    rng = np.random.default_rng(len(name))
    shape = {"1x1": 1, "8x1": 8, "1x8": 8, "5x3": 15}
    n = shape.get(name, 4096 * 3 + 17)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:, 1:] -= 0.5
    p = 1 if name == "p1" else 64
    cen = x[rng.integers(0, n, p)].copy()
    ok = np.ones(p, bool)
    if name == "duplicates":
        cen[p // 2:] = cen[:p // 2][::-1]
        x[::3] = cen[rng.integers(0, p, len(x[::3]))]  # exact ties
    elif name == "invalid":
        ok[::2] = False
    elif name == "constant":
        x[:] = x[0]
    elif name == "nonfinite":
        ok[0] = False
        for i, v in enumerate((np.nan, np.inf, -np.inf)):
            x[i::97, i] = v
        x[5, :] = np.nan
        cen[3, 1] = 0.0  # inf * 0: a NaN distance, the first one wins
    elif name == "nonfinite-centre":
        cen[7] = (np.inf, 0.0, 0.0)
        cen[9, 2] = np.nan
    planes = tuple(torch.from_numpy(x[:, i].copy()).to(DEV)
                   for i in range(3))
    return planes, torch.from_numpy(cen).to(DEV), torch.from_numpy(ok).to(DEV)


# K3's edge cases (kernel-k3-cases), each equal to the plain version bit
# for bit: the degenerate shapes, one centre, duplicated centres and exact
# ties, every other slot invalid, NaN and +-inf coordinates (slot 0
# invalid), a centre with inf and one with NaN, a constant image, and N
# not a multiple of the tile (3 tiles and 17 points)
K3_CASES = ("1x1", "8x1", "1x8", "5x3", "p1", "duplicates", "invalid",
            "nonfinite", "nonfinite-centre", "constant", "ragged")


def kernel_k3_cases(torch):
    from patolette_tpu_torch.kernels.assign import (assign_planar,
                                                    assign_planar_plain)
    from patolette_tpu_torch.kernels.lut import nearest_probe

    out = {}
    for name in K3_CASES:
        planes, cen, ok = _k3_case(torch, name)
        got = assign_planar(planes, cen, ok)
        twin = assign_planar_plain(planes, cen, ok)
        wide, counts = nearest_probe(planes, cen, ok, "sorted4096")
        torch.cuda.synchronize()
        differ = int((got != twin).sum())
        check(differ == 0, f"K3 case {name}: {differ} labels differ")
        check(torch.equal(wide, got), f"K3 case {name}: sorted4096 differs")
        out[name] = dict(n=planes[0].shape[0], centres=cen.shape[0],
                         valid=int(ok.sum()),
                         candidates=_k5_candidates(torch, counts))
    emit({"phase": "kernel-k3-cases", "cases": out, "identical": True})


def kernel_k4(torch, rows):
    from patolette_tpu_torch.kernels.kmeans import (kmeans_step,
                                                    kmeans_step_plain)

    m, p, iters = N_SAMPLES, 256, 4
    x = _working_pixels(torch, m, 6)
    g = torch.Generator(device=DEV).manual_seed(7)
    c0 = x[torch.randint(0, m, (p,), generator=g, device=DEV)].clone()
    c0[10] = 5.0  # a valid slot no sample is near: forces the split
    valid = torch.ones(p, dtype=torch.bool, device=DEV)
    valid[-2:] = False
    c_k, l_k = kmeans_step(x, None, c0, valid, return_labels=True)
    c_t, l_t = kmeans_step_plain(x, None, c0, valid)
    agree = _agreement(l_k, l_t)
    check(agree == 1.0, f"K4 step labels agree only {agree}")
    check(not bool((l_k == 10).any()), "K4 empty slot got samples")
    # one step: same labels, cluster sums of ~1000 samples in two orders
    err = float((c_k - c_t).abs().max())
    check(err <= 1e-6, f"K4 step centres deviate {err}")
    check(bool((c_k[10] - 5.0).abs().max() > 1.0), "K4 split did not run")
    ck, ct = c0, c0
    for _ in range(iters):
        ck = kmeans_step(x, None, ck, valid)
        ct, _ = kmeans_step_plain(x, None, ct, valid)
    ck2 = c0
    for _ in range(iters):
        ck2 = kmeans_step(x, None, ck2, valid)
    torch.cuda.synchronize()
    # after the first step the two sides may assign a sample at a near-tie
    # differently, which moves a centre by ~(x - c) / cluster size
    err_iters = float((ck - ct).abs().max())
    check(err_iters <= 1e-3, f"K4 centres deviate {err_iters} after {iters}")
    check(torch.equal(ck, ck2), "K4 not deterministic")
    # with a reduction between the moments and the update, as the
    # multi-device route runs it: against the plain step with the same one
    def double(mom):  # two ranks' equal sums
        return mom * 2.0

    c_red = kmeans_step(x, None, c0, valid, reduce=double)
    c_red_t, _ = kmeans_step_plain(x, None, c0, valid, reduce=double)
    err_red = float((c_red - c_red_t).abs().max())
    check(err_red <= 1e-6, f"K4 with a reduction deviates {err_red}")
    check(torch.equal(kmeans_step(x, None, c0, valid,
                                  reduce=lambda mom: mom.clone()), c_k),
          "K4 with an identity reduction differs from the step")
    ms = time_ms(lambda: kmeans_step(x, None, c0, valid))
    plain = time_ms(lambda: kmeans_step_plain(x, None, c0, valid),
                    reps=10, warm=1)
    b, by = bound_ms(m * 12 + p * 12 * 2 + p * 4,
                     m * int(valid.sum()) * 7 + m * 4)
    rows.append(dict(name="kmeans_step", shape=[m, p, iters],
                     label_agreement=agree, max_abs_err=err,
                     max_abs_err_after_iters=err_iters,
                     max_abs_err_reduced=err_red, ms=ms,
                     plain_ms=plain, library_ms=None, bound_ms=b,
                     bound_by=by))


def kernel_k4_adversarial(torch):
    """K4 at P = 1, with every sample nearest one centre (the other 255
    valid slots empty: 255 splits), zero weights on a third of the samples,
    two centres exactly equal (the lower index must win), and non-finite
    samples and centres: labels equal to the plain version's, centres
    within its tolerance (non-finite ones equal), the same bits twice."""
    from patolette_tpu_torch.kernels.kmeans import (kmeans_step,
                                                    kmeans_step_plain)

    m, p = N_SAMPLES, 256
    x = _working_pixels(torch, m, 42)
    g = torch.Generator(device=DEV).manual_seed(43)

    def pick(k):
        return x[torch.randint(0, m, (k,), generator=g, device=DEV)].clone()

    def every(k):
        return torch.ones(k, dtype=torch.bool, device=DEV)

    far = pick(p)
    far[1:] += 5.0
    tie = pick(p)
    tie[200] = tie[7]
    w = torch.rand((m,), generator=g, device=DEV)
    w[torch.rand((m,), generator=g, device=DEV) < 1.0 / 3.0] = 0.0
    # argmin takes the first NaN distance: NaN and +-inf samples (every
    # 97th from a channel's own offset, one sample NaN in all three) with
    # slot 0 invalid; +inf samples against a centre with a zero coordinate
    # (inf x 0: NaN for it, -inf or +inf for the others); a centre at (inf,
    # 0, 0) and one with a NaN, in the resident and the tiled scan
    bad = x.clone()
    for i, v in enumerate((float("nan"), float("inf"), float("-inf"))):
        bad[i::97, i] = v
    bad[5] = float("nan")
    no_first = every(p)
    no_first[0] = False
    inf0 = x.clone()
    inf0[::53, 0] = float("inf")
    zero = pick(p)
    zero[3, 0] = 0.0
    wild = pick(p)
    wild[7] = torch.tensor([float("inf"), 0.0, 0.0], device=DEV)
    wild[9, 2] = float("nan")
    wild_large = pick(P_LARGE)
    wild_large[P_LARGE - 100] = wild[7]
    wild_large[P_LARGE - 50, 0] = float("nan")
    cases = {"p_1": (x, None, pick(1), every(1)),
             "one_centre_nearest": (x, None, far, every(p)),
             "zero_weights": (x, w, pick(p), every(p)),
             "exact_ties": (x, None, tie, every(p)),
             "nonfinite_samples": (bad, None, pick(p), no_first),
             "inf_times_zero": (inf0, None, zero, every(p)),
             "nonfinite_centres": (x, None, wild, every(p)),
             "nonfinite_centres_tiled": (x, None, wild_large,
                                         every(P_LARGE))}
    out = {"phase": "kernel-adversarial", "kernel": "kmeans_step"}
    for name, (xs, wt, c0, valid) in cases.items():
        c_k, l_k = kmeans_step(xs, wt, c0, valid, return_labels=True)
        c_t, l_t = kmeans_step_plain(xs, wt, c0, valid)
        c_k2, l_k2 = kmeans_step(xs, wt, c0, valid, return_labels=True)
        torch.cuda.synchronize()
        agree = _agreement(l_k, l_t)
        check(agree == 1.0, f"K4 {name}: labels agree only {agree}")
        # centres within the sums' rounding, where every sample is finite:
        # the plain version sums by a one-hot product (as the JAX package's
        # segment_matmul), whose 0 x inf spreads NaN to every cluster, where
        # the kernel sums each cluster's members only
        err = None
        if bool(torch.isfinite(xs).all()):
            same = (torch.isnan(c_k) == torch.isnan(c_t)) & (
                (c_k == c_t) | torch.isnan(c_k)
                | (torch.isfinite(c_k) & torch.isfinite(c_t)))
            check(bool(same.all()), f"K4 {name}: non-finite centres differ")
            err = float((c_k - c_t).nan_to_num(0.0).abs().max())
            check(err <= 1e-6, f"K4 {name}: centres deviate {err}")
        check(torch.equal(c_k.nan_to_num(2.0), c_k2.nan_to_num(2.0))
              and torch.equal(l_k, l_k2), f"K4 {name}: not deterministic")
        if name == "exact_ties":
            check(bool((l_k == 7).any()) and not bool((l_k == 200).any()),
                  "K4: a tie went to the higher index")
        out[name] = {"p": c0.shape[0], "label_agreement": agree,
                     "max_abs_err": err}
    emit(out)


def kernel_k4_large(torch, rows):
    """K4 above the shared-memory table (P_LARGE): centres tiled through
    shared memory, per-block tables and the finalize in device memory."""
    from patolette_tpu_torch.kernels.kmeans import (kmeans_step,
                                                    kmeans_step_plain)

    m, p = N_SAMPLES, P_LARGE
    x = _working_pixels(torch, m, 8)
    g = torch.Generator(device=DEV).manual_seed(9)
    c0 = x[torch.randint(0, m, (p,), generator=g, device=DEV)].clone()
    far = [10, p // 2, p - 100]
    c0[far] = 5.0  # valid slots no sample is near: splits
    valid = torch.ones(p, dtype=torch.bool, device=DEV)
    valid[-2:] = False
    c_k, l_k = kmeans_step(x, None, c0, valid, return_labels=True)
    c_t, l_t = kmeans_step_plain(x, None, c0, valid)
    c_k2 = kmeans_step(x, None, c0, valid)
    torch.cuda.synchronize()
    agree = _agreement(l_k, l_t)
    check(agree == 1.0, f"K4[{p}] labels agree only {agree}")
    err = float((c_k - c_t).abs().max())
    # same labels; cluster sums of ~32 samples in two orders
    check(err <= 1e-6, f"K4[{p}] centres deviate {err}")
    check(bool((c_k[far[1]] - 5.0).abs().max() > 1.0), f"K4[{p}] no split")
    check(torch.equal(c_k, c_k2), f"K4[{p}] not deterministic")
    ms = time_ms(lambda: kmeans_step(x, None, c0, valid))
    plain = time_ms(lambda: kmeans_step_plain(x, None, c0, valid), reps=3,
                    warm=1)
    b, by = bound_ms(m * 12 + p * 12 * 2 + p * 4,
                     m * int(valid.sum()) * 7 + m * 4)
    rows.append(dict(name=f"kmeans_step[{p}]", shape=[m, p],
                     label_agreement=agree, max_abs_err=err, ms=ms,
                     plain_ms=plain, library_ms=None, bound_ms=b,
                     bound_by=by))


def _k5_candidates(torch, counts):
    """Mean and max of a probe's centres scanned per warp."""
    c = counts.to(torch.float64)
    return [float(c.mean()), int(counts.max())]


def _k5_hold(torch, grid, centers, valid, dtype, what):
    """K5 on ``grid`` equal to its plain version and to K3's map of the same
    points; returns the table and the pruned probe's candidate counts."""
    from patolette_tpu_torch.kernels.assign import assign_planar
    from patolette_tpu_torch.kernels.lut import (BRICK_SLAB, lut_argmin,
                                                 lut_argmin_plain,
                                                 nearest_probe)

    n = grid[0].shape[0]
    got = lut_argmin(grid, centers, valid, dtype)
    twin = lut_argmin_plain(grid, centers, valid, dtype)
    direct = assign_planar(grid, centers, valid)
    labels, counts = nearest_probe(
        grid, centers, valid, "brick" if n % BRICK_SLAB == 0 else "linear")
    torch.cuda.synchronize()
    check(got.dtype == dtype and got.shape == (n,), f"K5 {what}: output")
    mismatches = int((got != twin).sum())
    check(mismatches == 0, f"K5 {what} differs from its plain version")
    check(torch.equal(got.to(torch.int32), direct),
          f"K5 {what} differs from K3 on the grid")
    check(torch.equal(labels, direct), f"K5 {what}: the probe's labels")
    return got, _k5_candidates(torch, counts), mismatches




def kernel_k5(torch, rows):
    """K5 on the cached ICtCp grid at P = 256 (u8) and P = 1024 (u16):
    identical to its plain version and to K3 on all 2^24 codes; the
    centres each warp scanned (mean, max) and, through the probe, the
    pruned scan's count and time in K3's linear layout beside K5's brick
    layout; then the
    adversarial palettes (kernels.lut.adversarial_palettes) on all 2^24
    codes, and the 256-colour palette on a mesh rank's quarter slice of the
    grid, equal to its plain version and to the whole table's quarter."""
    from patolette_tpu_torch.kernels.lut import (adversarial_palettes,
                                                 lut_argmin, lut_argmin_plain,
                                                 nearest_probe)
    from patolette_tpu_torch.ops import lut

    lut.clear_grid_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid = lut.grid_ictcp(2, DEV)
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) * 1e3
    n = lut.LUT_SIZE
    tables = {}
    for p, dtype, name in ((256, torch.uint8, "lut_argmin"),
                           (1024, torch.uint16, "lut_argmin[1024]")):
        centers = _working_pixels(torch, p, 20 + p)
        valid = torch.ones(p, dtype=torch.bool, device=DEV)
        valid[-3:] = False
        got, cand, mismatches = _k5_hold(torch, grid, centers, valid, dtype,
                                         f"[{p}]")
        tables[p] = got
        ms = time_ms(lambda: lut_argmin(grid, centers, valid, dtype))
        plain = time_ms(lambda: lut_argmin_plain(grid, centers, valid, dtype),
                        reps=3, warm=1)
        scans = {}
        for scan in ("brick", "linear"):
            _, counts = nearest_probe(grid, centers, valid, scan)
            scans[scan] = dict(
                candidates=_k5_candidates(torch, counts),
                ms=time_ms(lambda: nearest_probe(grid, centers, valid, scan),
                           reps=5, warm=1))
        x = torch.stack(grid, 1)
        cv = centers[valid]
        step = 1 << 20

        def library():
            return torch.cat([torch.cdist(x[s:s + step], cv).argmin(1)
                              for s in range(0, n, step)])

        lib = time_ms(library, reps=3, warm=1)
        del x
        # the table's least time: the grid read and the table written (the
        # pruned scan does not do the brute force's 7 operations per code
        # and valid entry; that count's time stands beside it)
        b, by = bound_ms(n * 12 + p * 16 + n * got.element_size(), 0)
        brute = bound_ms(0, n * int(valid.sum()) * 7)[0]
        rows.append(dict(name=name, shape=[n, p], out_dtype=str(dtype),
                         max_abs_err=float(mismatches), ms=ms,
                         plain_ms=plain,
                         library_ms=lib, bound_ms=b, bound_by=by,
                         brute_force_operations_ms=brute,
                         candidates=cand, scans=scans,
                         grid_build_cold_ms=grid_ms))

    def grid_at(codes):
        idx = torch.as_tensor(codes, device=DEV)
        return torch.stack([g[idx] for g in grid], 1).cpu().numpy()

    adversarial = {}
    for kind, (cen, ok) in adversarial_palettes(grid_at, seed=1).items():
        dtype = torch.uint8 if len(cen) <= 256 else torch.uint16
        _, cand, _ = _k5_hold(torch, grid, torch.from_numpy(cen).to(DEV),
                              torch.from_numpy(ok).to(DEV), dtype, kind)
        adversarial[kind] = dict(entries=len(cen), valid=int(ok.sum()),
                                 candidates=cand)
    # a mesh rank's quarter (world 4, rank 1): its own slice of the grid
    centers = _working_pixels(torch, 256, 20 + 256)
    valid = torch.ones(256, dtype=torch.bool, device=DEV)
    valid[-3:] = False
    del grid
    per = n // 4
    quarter = lut.grid_ictcp_slice(2, DEV, 1, 4)
    got, cand, _ = _k5_hold(torch, quarter, centers, valid, torch.uint8,
                            "quarter")
    check(torch.equal(got, tables[256][per:2 * per]),
          "K5 on the quarter slice differs from the table's quarter")
    emit({"phase": "kernel-k5-adversarial", "cases": adversarial,
          "quarter": dict(rank=1, world=4, candidates=cand),
          "identical": True})
    # the e2e phases' peak device memory counts what their calls hold
    lut.clear_grid_cache()
    return tables


def kernel_k6(torch, rows):
    """K6 on the 2^24 table of a 256-colour palette drawn from the 4K
    uint8 image, and on its second quarter (a rank's slice at world 4):
    header and words equal to the plain version, the host decode equal to
    the table; an alternating table must flag overflow."""
    import numpy as np

    from patolette_tpu_torch.kernels.rle import (header, rle_encode_u8_v2,
                                                 rle_encode_u8_v2_plain)
    from patolette_tpu_torch.ops import colorspace as cs
    from patolette_tpu_torch.ops import lut

    img = synth_image_u8(W, H)
    idx = np.random.default_rng(30).integers(0, W * H, size=256)
    centers = cs.srgb_to_working(torch.from_numpy(img[idx]).to(DEV), 2)
    valid = torch.ones(256, dtype=torch.bool, device=DEV)
    table = lut.build_lut_device(centers, valid, 2)
    lut.clear_grid_cache()
    n = lut.LUT_SIZE
    out = {}
    for name, t in (("full", table), ("quarter", table[n // 4:n // 2])):
        enc = rle_encode_u8_v2(t)
        twin = rle_encode_u8_v2_plain(t)
        torch.cuda.synchronize()
        count, over = header(enc)
        check(not over and header(twin) == (count, over),
              f"K6 {name}: header {header(enc)} against {header(twin)}")
        words = enc[3:3 + count].cpu().numpy()
        diff = int((words != twin[3:3 + count].cpu().numpy()).sum())
        check(diff == 0, f"K6 {name}: {diff} words differ")
        dec = lut.rle_decode_u8_v2(words, np.empty((t.shape[0],), np.uint8))
        check(np.array_equal(dec, t.cpu().numpy()),
              f"K6 {name}: decode differs from the table")
        out[name] = (t, count, diff)
    alt = torch.arange(n, device=DEV).remainder(2).to(torch.uint8)
    count_alt, over_alt = header(rle_encode_u8_v2(alt))
    check(over_alt and count_alt == n and
          header(rle_encode_u8_v2_plain(alt)) == (n, True),
          "K6 did not flag the alternating table")
    for name, (t, count, diff) in out.items():
        ms = time_ms(lambda: rle_encode_u8_v2(t))
        plain = time_ms(lambda: rle_encode_u8_v2_plain(t), reps=3, warm=1)
        b, by = bound_ms(t.shape[0] + 2 * (3 + count), 0)
        rows.append(dict(
            name="rle_encode_u8_v2" + ("" if name == "full" else "[quarter]"),
            shape=[t.shape[0]], runs=count, max_abs_err=float(diff), ms=ms,
            plain_ms=plain, library_ms=_runs_library_ms(torch, t),
            bound_ms=b, bound_by=by))


def _runs_library_ms(torch, t):
    """One PyTorch call that finds the same runs: their values and lengths
    (not K6's words). A u16 table goes in as its int16 view (the same
    runs), the types that call takes on the card."""
    if t.dtype == torch.uint16:
        t = t.view(torch.int16)
    return time_ms(lambda: torch.unique_consecutive(t, return_counts=True),
                   reps=3, warm=1)


def _block_table(torch, n, dtype):
    """A table of n entries that is constant but for one 128-block that
    alternates (64 run starts, over v2's cap of 32)."""
    t = torch.zeros(n, dtype=dtype, device=DEV)
    t[4096:4096 + 128] = (torch.arange(128, device=DEV) % 2 + 3).to(dtype)
    return t


def _k6_words(rle, fn, enc):
    """(count, overflow, the words a reader may read) of a K6 buffer."""
    if fn is rle.rle_encode_u8:
        count = rle.header_v1(enc)
        return count, count > rle.MAX_RUNS, enc[1:1 + min(count,
                                                          rle.MAX_RUNS)]
    if fn is rle.rle_encode_u8_v2:
        (count, over), hdr = rle.header(enc), 3
    else:
        (count, over), hdr = rle.header_u16_v2(enc), 2
    return count, over, enc[hdr:hdr + (0 if over else count)]


def kernel_k6_cases(torch):
    """K6 in its three formats on two crafted 2^24 tables: runs of 1001
    entries, so a run crosses every boundary of the kernel's groups of
    32768 entries (and of every row but the forced starts), and a constant
    table whose last 128-block alternates (a row over v2's cap of 32 at
    the very end: the last group's overflow reaches the header). Header
    and words equal to the plain version's, and the same twice."""
    from patolette_tpu_torch.kernels import rle

    n = 1 << 24
    runs = torch.arange(n, device=DEV) // 1001
    tail = torch.zeros(n, dtype=torch.int64, device=DEV)
    tail[-128:] = torch.arange(128, device=DEV) % 2 + 7
    tables = {"crossing": runs, "overflowing-tail": tail}
    out = {}
    for tname, t in tables.items():
        for fn, plain_fn, dtype in (
                (rle.rle_encode_u8_v2, rle.rle_encode_u8_v2_plain,
                 torch.uint8),
                (rle.rle_encode_u8, rle.rle_encode_u8_plain, torch.uint8),
                (rle.rle_encode_u16_v2, rle.rle_encode_u16_v2_plain,
                 torch.uint16)):
            x = (t % (251 if dtype == torch.uint8 else 65521)).to(dtype)
            enc = fn(x)
            again = fn(x)
            twin = plain_fn(x)
            torch.cuda.synchronize()
            count, over, words = _k6_words(rle, fn, enc)
            t_count, t_over, t_words = _k6_words(rle, fn, twin)
            name = f"{fn.__name__}[{tname}]"
            check((count, over) == (t_count, t_over),
                  f"K6 {name}: header {(count, over)} against "
                  f"{(t_count, t_over)}")
            check(torch.equal(words, t_words), f"K6 {name}: words differ")
            a_count, a_over, a_words = _k6_words(rle, fn, again)
            check((a_count, a_over) == (count, over)
                  and torch.equal(a_words, words),
                  f"K6 {name}: not deterministic")
            check(over == (tname == "overflowing-tail"
                           and fn is not rle.rle_encode_u8),
                  f"K6 {name}: overflow {over}")
            out[name] = dict(runs=count, overflow=over)
    emit({"phase": "kernel-k6-cases", "cases": out, "identical": True})


def kernel_k6_pull(torch, rows, tables):
    """K6's v1 (u8) and u16 v2 formats on K5's 256- and 1024-colour tables
    and on crafted tables: header and words equal to the plain version
    (v1: the first min(count, MAX_RUNS) words, also past its cap), the host
    decode equal to the table; u16 v2 must flag a block over its cap."""
    import numpy as np

    from patolette_tpu_torch.kernels import rle
    from patolette_tpu_torch.ops import lut

    n = lut.LUT_SIZE
    alt = torch.arange(n, device=DEV).remainder(2).to(torch.uint8)
    cases = (
        ("rle_encode_u8", tables[256], rle.rle_encode_u8,
         rle.rle_encode_u8_plain),
        ("rle_encode_u8[block]", _block_table(torch, n, torch.uint8),
         rle.rle_encode_u8, rle.rle_encode_u8_plain),
        ("rle_encode_u8[alternating]", alt, rle.rle_encode_u8,
         rle.rle_encode_u8_plain),
        ("rle_encode_u16_v2", tables[1024], rle.rle_encode_u16_v2,
         rle.rle_encode_u16_v2_plain),
        ("rle_encode_u16_v2[block]", _block_table(torch, n, torch.uint16),
         rle.rle_encode_u16_v2, rle.rle_encode_u16_v2_plain),
    )
    for name, t, fn, plain_fn in cases:
        enc = fn(t)
        twin = plain_fn(t)
        torch.cuda.synchronize()
        host = t.cpu().numpy()
        if t.dtype == torch.uint8:
            hdr, count = 1, rle.header_v1(enc)
            over = count > rle.MAX_RUNS
            check(rle.header_v1(twin) == count,
                  f"{name}: count {count} against {rle.header_v1(twin)}")
            n_words = min(count, rle.MAX_RUNS)
            out_bytes = 4 * (1 + n_words)
        else:
            hdr, (count, over) = 2, rle.header_u16_v2(enc)
            check(rle.header_u16_v2(twin) == (count, over),
                  f"{name}: header {(count, over)} against "
                  f"{rle.header_u16_v2(twin)}")
            n_words = 0 if over else count
            out_bytes = 4 * (2 + count)
        words = enc[hdr:hdr + n_words].cpu().numpy()
        diff = int((words != twin[hdr:hdr + n_words].cpu().numpy()).sum())
        check(diff == 0, f"{name}: {diff} words differ")
        if name == "rle_encode_u8[block]":
            check(count == 130 and not over, f"{name}: count {count}")
        if name == "rle_encode_u8[alternating]":
            check(count == n and over, f"{name}: count {count}")
        if name == "rle_encode_u16_v2[block]":
            check(over, f"{name}: overflow not flagged")
        if not over:
            if t.dtype == torch.uint8:
                dec = lut.rle_decode_u8(words, np.empty(n, np.uint8))
            else:
                dec = lut.rle_decode_u16_v2(words, np.empty(n, np.uint16))
            check(np.array_equal(dec, host),
                  f"{name}: decode differs from the table")
        ms = time_ms(lambda: fn(t))
        plain = time_ms(lambda: plain_fn(t), reps=3, warm=1)
        b, by = bound_ms(t.numel() * t.element_size() + out_bytes, 0)
        rows.append(dict(
            name=name, shape=[n], out_dtype=str(t.dtype), runs=count,
            overflow=over, max_abs_err=float(diff), ms=ms, plain_ms=plain,
            library_ms=_runs_library_ms(torch, t), bound_ms=b,
            bound_by=by))


# K7's shapes (kernel-k7-cases), each bit for bit equal to the plain
# version, a bijection, and the same twice: the 4K image, one strip of the
# 100 MP call (its rows from the pipeline's strip size), the smallest and
# thinnest images, 40000 px sides (order 16: 4.3 G cells in the curve's
# square), sides just over a power of two
K7_SHAPES = ((W, H), (HEADLINE_W, None), (1, 1), (8, 1), (1, 8), (5, 3),
             (7, 3), (3, 40000), (40000, 3), (4097, 2), (2, 4097))


def _k7_shapes():
    """K7_SHAPES with the strip's rows filled in."""
    return tuple((w, h if h is not None else _strip_count(w, HEADLINE_H)[1])
                 for w, h in K7_SHAPES)


def kernel_k7(torch, rows):
    """K7 (the visit order, no sort) at K7_SHAPES; timed at the 4K image
    and the 100 MP call's strip beside the plain version (keys and an
    argsort on the card)."""
    from patolette_tpu_torch.kernels.hilbert import (pixel_visit_order_plain,
                                                     visit_order)

    out = {}
    for w, h in _k7_shapes():
        got = visit_order(w, h, DEV)
        twin = pixel_visit_order_plain(w, h, DEV)
        again = visit_order(w, h, DEV)
        seen = torch.zeros(w * h, dtype=torch.int32, device=DEV)
        seen.index_add_(0, got.long(), torch.ones_like(got))
        torch.cuda.synchronize()
        differ = int((got != twin).sum())
        check(differ == 0, f"K7 {w}x{h}: {differ} entries differ")
        check(torch.equal(got, again), f"K7 {w}x{h}: not deterministic")
        check(bool((seen == 1).all()), f"K7 {w}x{h}: not a bijection")
        out[f"{w}x{h}"] = "equal"
        if (w, h) != (W, H) and w != HEADLINE_W:
            continue
        ms = time_ms(lambda: visit_order(w, h, DEV))
        plain = time_ms(lambda: pixel_visit_order_plain(w, h, DEV), reps=3,
                        warm=1)
        b, by = bound_ms(w * h * 4, 0)  # the permutation written
        rows.append(dict(name="visit_order" + ("" if w == W else "[strip]"),
                         shape=[w, h], max_abs_err=float(differ), ms=ms,
                         plain_ms=plain, library_ms=None, bound_ms=b,
                         bound_by=by))
    emit({"phase": "kernel-k7-cases", "cases": out, "identical": True})


def _linear_image(torch, w, h):
    """The synthetic 4K image in linear Rec2020 planes on the card."""
    from patolette_tpu_torch.ops import colorspace as cs

    x = torch.from_numpy(synth_image_f32(w, h)).to(DEV)
    return tuple(ch.contiguous() for ch in cs.srgb_to_linear_rec2020(
        tuple(x[:, k] for k in range(3))))


def sm_clock_hz():
    """The card's highest SM clock (nvidia-smi), for K8's chain bound."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return float(out.stdout.split()[0]) * 1e6


def k8_chain_cycles(k, group):
    """The least latency of one K8 step (csrc/dither.cu) in cycles, with
    every independent operation issued at once: (px + S) * cw (2 dependent
    f32 operations), the shuffles of q (1), one distance (5: a product, two
    sums, the doubling, the difference), the minimum of a thread's K / G
    entries as a tree (log2 levels of 2), log2(G) shuffle levels (a shuffle
    and 2 operations each), the raw colour's shared-memory load, the error,
    its product and the sum (3)."""
    import math

    per = max(1, -(-k // group))
    levels = math.ceil(math.log2(per)) if per > 1 else 0
    return (LAT_F32 * (2 + 5 + 2 * levels + 3) + LAT_SHFL
            + int(math.log2(group)) * (LAT_SHFL + 2 * LAT_F32) + LAT_LDS)


def _k8_palette(torch, ch, p, kind, seed=11):
    """(linear Rec2020 entries (p, 3), valid (p,)) drawn from the pixels:
    "random" (the last 3 slots invalid when p > 3), "duplicates" (the
    first half again in reverse: exact ties), "invalid" (every other slot,
    slot 0 among them)."""
    n = ch[0].shape[0]
    g = torch.Generator(device=DEV).manual_seed(seed + p)
    pick = torch.randint(0, n, (p,), generator=g, device=DEV)
    if kind == "duplicates":
        pick = torch.cat([pick[:p // 2], pick[:p // 2].flip(0)])
    pal = torch.stack([c[pick] for c in ch], 1)
    valid = torch.ones(p, dtype=torch.bool, device=DEV)
    if kind == "invalid":
        valid[::2] = False
    elif p > 3:
        valid[-3:] = False
    return pal, valid


# K8 threads a lane swept at the 4K shape (the wrapper's rule comes from
# this sweep)
K8_GROUPS = (4, 8, 16, 32)


def kernel_k8(torch, rows):
    """K8 at the default call's 4K shape (256 colours, segment 4096)
    against its plain version, at each of K8_GROUPS (bit for bit, timed),
    and its bound: the larger of the operations and the chain (segment
    steps of k8_chain_cycles at the highest SM clock)."""
    from patolette_tpu_torch.kernels.dither import (dither_scan,
                                                    dither_scan_group,
                                                    dither_scan_plain,
                                                    group_for, lane_shape,
                                                    palette_table)
    from patolette_tpu_torch.ops import hilbert

    w, h, p, seg = W, H, 256, 4096
    n = w * h
    ch = _linear_image(torch, w, h)
    pal, valid = _k8_palette(torch, ch, p, "random")
    table = palette_table(pal, valid)
    perm = hilbert.pixel_visit_order(w, h, DEV)
    got = dither_scan(ch, perm, table, seg)
    twin = dither_scan_plain(ch, perm, table, seg)
    again = dither_scan(ch, perm, table, seg)
    torch.cuda.synchronize()
    agree = _agreement(got, twin)
    check(agree == 1.0, f"K8 labels agree only {agree}")
    check(torch.equal(got, again), "K8 not deterministic")
    check(not bool((got >= p - 3).any()), "K8 chose an invalid slot")
    groups = {}
    for g in K8_GROUPS:
        other = dither_scan_group(ch, perm, table, seg, g)
        torch.cuda.synchronize()
        check(torch.equal(other, got), f"K8 at G = {g} differs")
        groups[g] = time_ms(
            lambda: dither_scan_group(ch, perm, table, seg, g))
    ms = time_ms(lambda: dither_scan(ch, perm, table, seg))
    plain = time_ms(lambda: dither_scan_plain(ch, perm, table, seg), reps=1,
                    warm=0)
    kv = int(valid.sum())
    group = group_for(p)
    cycles = k8_chain_cycles(p, group)
    clock = sm_clock_hz()
    chain = seg * cycles / clock * 1e3
    b, by = bound_ms(n * (12 + 4 + 4) + p * 32,
                     n * (7 * kv + 2 * 3 * 16 + 9))
    if chain > b:
        b, by = chain, "operations"
    rows.append(dict(name="dither_scan", shape=[n, p, seg],
                     lanes=lane_shape(n, seg)[1], label_agreement=agree,
                     max_abs_err=float((got != twin).sum()), ms=ms,
                     plain_ms=plain, library_ms=None, bound_ms=b,
                     bound_by=by, chain_cycles_a_step=cycles,
                     sm_clock_mhz=clock / 1e6, chain_ms=chain, group=group,
                     groups_ms=groups))


# K8's cases (kernel-k8-cases): (name, width, height, entries, segment,
# palette kind), each bit for bit equal to the plain version at every G
# and through the wrapper, twice: one and two entries, the tiled walk
# (4096 entries), one lane (segment 0) at 5x3, lanes of one step, 1x1,
# 8x1, 1x8, n < 32, a short last lane (4096 + 904), lanes of 37 steps,
# duplicated entries (exact ties), every other slot invalid, and the
# non-finite inputs of _k8_nonfinite (in registers and in the tiled walk)
K8_CASES = (
    ("p1", 96, 64, 1, 4096, "random"),
    ("p2", 96, 64, 2, 4096, "random"),
    ("p4096-tiled", 256, 256, 4096, 4096, "random"),
    ("segment0-5x3", 5, 3, 16, 0, "random"),
    ("segment1", 96, 64, 16, 1, "random"),
    ("1x1", 1, 1, 16, 4096, "random"),
    ("8x1", 8, 1, 16, 4096, "random"),
    ("1x8", 1, 8, 16, 4096, "random"),
    ("7x3", 7, 3, 16, 4096, "random"),
    ("short-last-lane", 100, 50, 256, 4096, "random"),
    ("segment37", 96, 64, 256, 37, "random"),
    ("duplicates", 96, 64, 256, 4096, "duplicates"),
    ("invalid", 96, 64, 256, 4096, "invalid"),
    ("nonfinite", 96, 64, 256, 37, "nonfinite"),
    ("inf-times-zero", 96, 64, 256, 37, "inf-times-zero"),
    ("nonfinite-entries", 96, 64, 256, 37, "nonfinite-entries"),
    ("nonfinite-entries-tiled", 256, 256, 4096, 4096, "nonfinite-entries"),
)


def _k8_nonfinite(torch, ch, pal, valid, kind):
    """K8_CASES' non-finite inputs (argmin takes the first NaN distance):
    "nonfinite", NaN, +inf and -inf in each channel of every 97th pixel
    from the channel's own offset and a pixel NaN in all three, slot 0
    invalid; "inf-times-zero", +inf in channel 0 of every 53rd pixel
    against entry 3, whose channel 0 is 0 (inf x 0: a NaN distance for
    entry 3, -inf or +inf for the others); "nonfinite-entries", entry 7 at
    (inf, 0, 0) and a NaN in entry 9. A pushed error is the uncorrected
    pixel's, so a bad pixel sways its lane for 16 steps."""
    ch = tuple(c.clone() for c in ch)
    if kind == "nonfinite":
        for i, v in enumerate((float("nan"), float("inf"), float("-inf"))):
            ch[i][i::97] = v
        for c in ch:
            c[5] = float("nan")
        valid[0] = False
    elif kind == "inf-times-zero":
        ch[0][::53] = float("inf")
        pal[3, 0] = 0.0
    elif kind == "nonfinite-entries":
        pal[7] = torch.tensor([float("inf"), 0.0, 0.0], device=DEV)
        pal[9, 2] = float("nan")
    return ch, pal, valid


def kernel_k8_cases(torch):
    from patolette_tpu_torch.kernels.dither import (dither_scan,
                                                    dither_scan_group,
                                                    dither_scan_plain,
                                                    group_for, palette_table)
    from patolette_tpu_torch.ops import hilbert

    out = {}
    for name, w, h, p, seg, kind in K8_CASES:
        ch = _linear_image(torch, w, h)
        pal, valid = _k8_palette(torch, ch, p, kind)
        ch, pal, valid = _k8_nonfinite(torch, ch, pal, valid, kind)
        table = palette_table(pal, valid)
        perm = hilbert.pixel_visit_order(w, h, DEV)
        twin = dither_scan_plain(ch, perm, table, seg)
        got = dither_scan(ch, perm, table, seg)
        again = dither_scan(ch, perm, table, seg)
        others = {g: dither_scan_group(ch, perm, table, seg, g)
                  for g in K8_GROUPS}
        torch.cuda.synchronize()
        differ = int((got != twin).sum())
        check(differ == 0, f"K8 case {name}: {differ} labels differ")
        check(torch.equal(got, again), f"K8 case {name}: not deterministic")
        for g, o in others.items():
            check(torch.equal(o, twin), f"K8 case {name} at G = {g} differs")
        out[name] = dict(n=w * h, entries=p, valid=int(valid.sum()),
                         segment=seg, group=group_for(p))
    emit({"phase": "kernel-k8-cases", "cases": out, "identical": True})


def _mbd_image(torch, rows_, cols, kind="texture"):
    """A (rows, cols) channel-mean image: bench.py's texture, one constant
    (every barrier ties), or the texture on 8 levels (b1 = b2 and d = b
    ties)."""
    x = torch.from_numpy(synth_image_f32(cols, rows_)).to(DEV)
    img = (x.sum(1) * (1.0 / 3.0)).reshape(rows_, cols).contiguous()
    if kind == "constant":
        return torch.full_like(img, 0.5)
    if kind == "levels":
        return torch.floor(img * 8.0) * 0.125
    return img


# K9's adversarial inputs (rows, cols, image): images with a side under 4
# (the planes initialised apart, then only the passes that have cells:
# the forward pass alone at 3xN and Nx3, none at 2x2 and 1x1), the
# smallest image with a cell in each pass, one band less a row, one band
# plus one row (wide and tall), a mesh-4 rank's strip, the 4K image
# upright, and the two tie images
K9_CASES = ((3, 50, "texture"), (50, 3, "texture"), (2, 2, "texture"),
            (1, 1, "texture"), (4, 4, "texture"), (31, 31, "texture"),
            (33, 4000, "texture"), (4000, 33, "texture"),
            (540, 3840, "texture"), (3840, 2160, "texture"),
            (300, 1000, "constant"), (300, 1000, "levels"))


def _k9_check(torch, img, what):
    """K9's d, l and u equal to its plain version's, and a rerun's."""
    from patolette_tpu_torch.kernels.mbd import mbd, mbd_plain

    got = mbd(img, return_lu=True)
    twin = mbd_plain(img)
    again = mbd(img, return_lu=True)
    torch.cuda.synchronize()
    for name, a, t, r in zip("dlu", got, twin, again):
        check(torch.equal(a, t), f"K9 {what}: {name} differs from the plain "
              "version")
        check(torch.equal(a, r), f"K9 {what}: {name} not deterministic")


def kernel_k9(torch, rows):
    from patolette_tpu_torch.kernels.mbd import mbd, mbd_plain

    out = {"phase": "kernel-adversarial", "kernel": "mbd"}
    for r, c, kind in K9_CASES:
        _k9_check(torch, _mbd_image(torch, r, c, kind), f"{r}x{c} {kind}")
        out[f"{r}x{c}_{kind}"] = "equal"
    emit(out)
    rows_, cols = H, W
    img = _mbd_image(torch, rows_, cols)
    _k9_check(torch, img, "4K")
    ms = time_ms(lambda: mbd(img))
    plain = time_ms(lambda: mbd_plain(img), reps=1, warm=0)
    n = rows_ * cols
    # the first pass reads img and writes l, u and d (it initialises them);
    # the other two read all four planes and write three
    b, by = bound_ms((16 + 28 + 28) * n, 3 * 8 * n)
    rows.append(dict(name="mbd", shape=[rows_, cols], max_abs_err=0.0,
                     ms=ms, plain_ms=plain, library_ms=None, bound_ms=b,
                     bound_by=by))


# K10's operations per pixel, (f32, f64), read off csrc/colorspace.cu: an
# _fma is an f64 multiply and add, a pow counts as ONE f64 operation (the
# least it could cost; libdevice's double pow runs tens of instructions),
# comparisons, selects and clamps count as f32 operations.
_DECODE, _ENCODE, _MAT = (5, 1), (4, 3), (3, 12)
_PQ_INV, _PQ_UNIT = (3, 6), (4, 4)
_XYZ_LUV, _LUV_XYZ, _LAB_F = (12, 7), (20, 6), (13, 5)


def _ops(*parts):
    return (sum(p[0] for p in parts), sum(p[1] for p in parts))


_TO_XYZ = _ops(*[_DECODE] * 3, _MAT)
_TO_2020 = _ops(_TO_XYZ, _MAT)
_2020_ICTCP = _ops(_MAT, *[_PQ_INV] * 3, _MAT)
_TO_ICTCP = _ops(_TO_2020, _2020_ICTCP)
_LUV_2020 = _ops(_LUV_XYZ, _MAT)
_2020_SRGB = _ops(_MAT, *[_ENCODE] * 3)
_ICTCP_2020 = _ops(_MAT, *[_PQ_UNIT] * 3, _MAT)
_WORKING = {0: (0, 0), 1: _ops(_TO_XYZ, _XYZ_LUV), 2: _TO_ICTCP}
_W_ICTCP = {0: _TO_ICTCP, 1: _ops(_LUV_2020, _2020_SRGB, _TO_ICTCP),
            2: (0, 0)}
_W_2020 = {0: _TO_2020, 1: _LUV_2020, 2: _ICTCP_2020}


def k10_ops(target, cs):
    """(f32, f64) operations per pixel of one K10 target in space cs."""
    if target == "working":
        return _WORKING[cs]
    if target == "ictcp":
        return _ops(_WORKING[cs], _W_ICTCP[cs])
    if target == "rec2020":
        return _ops(_WORKING[cs], _W_2020[cs])
    if target == "rec2020_direct":
        return _TO_2020
    if target == "lab":
        return _ops(_TO_XYZ, _LAB_F)
    if target == "working_to_ictcp":
        return _W_ICTCP[cs]
    return _W_2020[cs]


# K10's timed rows: (name, input, target, space, the path that gives its
# launches, the JAX composite it stands for). Every composite, input kind
# and space is checked for bit identity; these are the ones timed.
_JCS = "patolette_tpu/ops/colorspace.py:"
K10_ROWS = (
    ("color_convert[f32x3>working]", "f32x3", "working", 2, "main",
     _JCS + "353"),
    ("color_convert[codes>ictcp]", "codes", "ictcp", 2, "u8-lut",
     "patolette_tpu/ops/lut.py:87"),
    ("color_convert[lab]", "f32", "lab", 0, "default", _JCS + "329"),
    ("color_convert[f32x3>rec2020]", "f32x3", "rec2020", 2,
     "strip-dither", _JCS + "365"),
    ("color_convert[u8>rec2020_direct]", "u8", "rec2020_direct", 0,
     "strip-u8", _JCS + "301"),
    ("color_convert[f32x3>ictcp]", "f32x3", "ictcp", 2, "over-budget",
     _JCS + "376"),
)


def _k10_inputs(torch):
    """K10's inputs by kind: bench.py's synthetic 4K image as three f32
    planes, (N, 3) f32 and (N, 3) uint8, and all 2^24 codes."""
    import numpy as np

    img = synth_image_f32(W, H)
    x32 = torch.from_numpy(img).to(DEV)
    x8 = torch.from_numpy(np.round(img * 255.0).astype(np.uint8)).to(DEV)
    return {"f32": tuple(x32[:, k].contiguous() for k in range(3)),
            "f32x3": x32, "u8": x8,
            "codes": torch.arange(1 << 24, dtype=torch.int32, device=DEV)}


def kernel_k10(torch, rows):
    """K10 against its plain version on the card, bit for bit: every
    target in every working space from planar f32, (N, 3) f32 and (N, 3)
    uint8 4K pixels, the working-space targets from each space's working
    planes, and all 2^24 codes to ICtCp (also equal to the same codes sent
    as uint8 pixels, as the LUT's grid must be); then kernel_k10_pow."""
    from patolette_tpu_torch.kernels.colorspace import (color_convert,
                                                        color_convert_plain)

    inputs = _k10_inputs(torch)
    planes, codes = inputs["f32"], inputs["codes"]

    def differing(got, want):
        return sum(int((g != w).sum()) for g, w in zip(got, want))

    cases = []
    for c in (0, 1, 2):
        work = color_convert_plain(planes, c, "working")
        for target in ("working_to_ictcp", "working_to_rec2020"):
            cases.append((f"work>{target}[{c}]", work, c, target))
        for kind in ("f32", "f32x3", "u8"):
            for target in ("working", "ictcp", "rec2020", "rec2020_direct",
                           "lab"):
                cases.append((f"{kind}>{target}[{c}]", inputs[kind], c,
                              target))
        cases.append((f"codes>ictcp[{c}]", codes, c, "ictcp"))
    diffs = {}
    for name, x, c, target in cases:
        got = color_convert(x, c, target)
        want = color_convert_plain(x, c, target)
        torch.cuda.synchronize()
        check(all(g.shape == (x[0] if isinstance(x, tuple) else x).shape[:1]
                  for g in got), f"K10 {name}: bad shape")
        diffs[name] = differing(got, want)
        del got, want
    # the grid (codes) equals the same colours sent as uint8 pixels
    px = torch.stack([(codes >> s) & 0xFF for s in (16, 8, 0)],
                     1).to(torch.uint8).contiguous()
    for c in (0, 1, 2):
        diffs[f"codes=u8 pixels[{c}]"] = differing(
            color_convert(codes, c, "ictcp"), color_convert(px, c, "ictcp"))
    del px
    bad = {k: v for k, v in diffs.items() if v}
    check(not bad, f"K10 differs from its plain version: {bad}")
    emit({"phase": "kernel-k10-identity", "cases": len(diffs),
          "differing_values": sum(diffs.values())})
    pows = kernel_k10_pow(torch)

    for name, kind, target, c, _, _ in K10_ROWS:
        x = inputs[kind]
        m = (x[0] if isinstance(x, tuple) else x).shape[0]
        again = color_convert(x, c, target)
        ms = time_ms(lambda: color_convert(x, c, target))
        plain = time_ms(lambda: color_convert_plain(x, c, target), reps=3,
                        warm=1)
        in_bytes = {"u8": 3, "codes": 4}.get(kind, 12)
        f32_ops, f64_ops = k10_ops(target, c)
        b, by = bound_ms(m * (in_bytes + 12), m * f32_ops, m * f64_ops)
        rows.append(dict(name=name, shape=[m, c], max_abs_err=float(
            differing(again, color_convert_plain(x, c, target))),
            ms=ms, plain_ms=plain, library_ms=None, bound_ms=b,
            bound_by=by, ops_per_pixel=[f32_ops, f64_ops]))
        if name == K10_ROWS[0][0]:
            rows[-1]["pow_fallback"] = pows


def kernel_k10_pow(torch):
    """K10's pow_exact against libdevice's pow over all 2^32 f32 inputs of
    each exponent, counted on the card: no input may differ in any bit.
    Returns the fallback rates, over the positive finite inputs and over
    those whose power is an f32-normal number."""
    from patolette_tpu_torch.kernels.colorspace import (POW_EXPONENTS,
                                                        pow_exact_check)

    out = {}
    t0 = time.perf_counter()
    for name, e in POW_EXPONENTS.items():
        c = pow_exact_check(e, DEV)
        check(c["differ"] == 0,
              f"pow_exact differs from pow on {c['differ']} inputs of {name}")
        out[name] = dict(c, fell_rate=c["fell"] / 0x7F7FFFFF,
                         fell_normal_rate=c["fell_normal"] / max(1,
                                                                 c["normal"]))
    emit({"phase": "kernel-k10-pow", "inputs_each": 1 << 32,
          "seconds": time.perf_counter() - t0, "exponents": out})
    return {k: [v["fell_rate"], v["fell_normal_rate"]]
            for k, v in out.items()}


# K11's chain: the levels of the DP depend on each other
def k11_chain_cycles(k_max, b=512):
    """The least latency of K11's work in cycles, with every independent
    operation issued at once: the prefix as a tree scan (log2(b) levels of
    one addition), one cell cost D(t, n) (a level-independent table: a
    difference, a product, two sums, the quotient (counted as one), the
    difference and the clamp: 7), then at each level after the first the
    candidate's sum E_{k-1}[t] + D(t, n) (1) and the minimum over up to b
    candidates as a tree (log2(b) levels of a compare and a select)."""
    import math

    lg = math.ceil(math.log2(b))
    return LAT_F32 * (lg + 7 + (k_max - 1) * (1 + 2 * lg))


def image_bucket_moments(torch, w, h):
    """The one-shot route's GQ bucket moments of the w x h synthetic image
    (ICtCp, its 2^18-pixel LQ draw), on the card."""
    from patolette_tpu_torch.kernels.colorspace import color_convert
    from patolette_tpu_torch.models import kmeans as KM
    from patolette_tpu_torch.models import pipeline

    x = torch.from_numpy(synth_image_f32(w, h)).to(DEV)
    planes = color_convert(x, 2, "working")
    x_lq, _ = pipeline._subsample_device(
        planes, None, N_SAMPLES, KM.device_generator(x.device, 1234, 0))
    return pipeline._gq_bucket_stage(x_lq)[1].contiguous()


def _same_bits(torch, a, b):
    """Equal values, NaN where NaN (-0 equals 0)."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


# K11's checks: the bucket counts of the adversarial cases
# (kernels.gq.adversarial_moments), and the largest at which every
# cluster size of the sweep fits its shared memory
K11_BUCKETS = (1, 2, 33, 512, 1023)
K11_SWEEP_MAX_B = 512


def kernel_k11(torch, rows):
    """K11 (the GQ DP) against its plain version on the card: prefix,
    level costs, cut rows and chains identical, and gq_device's cuts and k
    through either, on the bucket moments of the 4K image (k_max 1, 2, 12)
    and the 2048x2048 image (every k_max 1 .. 12), random moments with
    empty buckets, all mass in one bucket, k_max 1, 2 and 12, a NaN bucket
    (in w2 and in w0), +inf and -inf, and the adversarial moments of
    kernels.gq.adversarial_moments at every b of K11_BUCKETS; at b <=
    K11_SWEEP_MAX_B every cluster size of the sweep gives the same bits
    (kernel-k11-cases). Then the sweep: each cluster size timed
    (kernel-k11-sweep; their device times come in the split phase)."""
    import numpy as np

    from patolette_tpu_torch.kernels import gq as KGQ
    from patolette_tpu_torch.models import global_q as GQ

    bm4k = image_bucket_moments(torch, W, H)
    bm2k = image_bucket_moments(torch, ONE_SHOT_W, ONE_SHOT_H)
    rnd = KGQ.random_moments(512, 1)
    cases = {"4k": (bm4k, 12), "4k_p1": (bm4k, 1), "4k_p2": (bm4k, 2)}
    for k_max in range(1, 13):
        cases[f"2048_p{k_max}"] = (bm2k, k_max)
    for name, mutate in (
            ("random", None), ("empty", "empty"),
            ("one_bucket", "one_bucket"), ("nan_w2", (200, 4, np.nan)),
            ("nan_w0", (300, 0, np.nan)), ("posinf", (100, 1, np.inf)),
            ("neginf", (300, 4, -np.inf))):
        bm = rnd.copy()
        if mutate == "empty":
            bm[:] = 0
        elif mutate == "one_bucket":
            total = bm.sum(0)
            bm[:] = 0
            bm[37] = total
        elif mutate is not None:
            bm[mutate[0], mutate[1]] = mutate[2]
        cases[name] = (torch.from_numpy(bm).to(DEV), 12)
        for k_max in (1, 2):
            if name in ("random", "nan_w2"):
                cases[f"{name}_p{k_max}"] = (cases[name][0], k_max)
    for b in K11_BUCKETS:
        for name, bm in KGQ.adversarial_moments(b).items():
            cases[f"{name}_b{b}"] = (torch.from_numpy(bm).to(DEV), 12)

    ks = {}
    swept = 0
    for name, (bm, k_max) in cases.items():
        got = KGQ.gq_dp(bm, k_max)
        want = KGQ.gq_dp_plain(bm, k_max)
        torch.cuda.synchronize()
        for what, g, w in zip(("prefix", "cost", "cut", "chains"), got,
                              want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"K11 {name}: {what} shape or type")
            check(_same_bits(torch, g, w), f"K11 {name}: {what} differs")
        if bm.shape[0] <= K11_SWEEP_MAX_B:
            for c in KGQ.CLUSTERS:
                other = KGQ.gq_dp_cluster(bm, k_max, c)
                for what, g, w in zip(("prefix", "cost", "cut", "chains"),
                                      other, want):
                    check(_same_bits(torch, g, w),
                          f"K11 {name} at C = {c}: {what} differs")
            swept += 1
        dev_cuts, dev_k = GQ.gq_device(bm, k_max)
        GQ.gq_dp = KGQ.gq_dp_plain
        try:
            plain_cuts, plain_k = GQ.gq_device(bm, k_max)
        finally:
            GQ.gq_dp = KGQ.gq_dp
        check(torch.equal(dev_cuts, plain_cuts)
              and int(dev_k) == int(plain_k), f"K11 {name}: cuts or k")
        ks[name] = int(dev_k)
    emit({"phase": "kernel-k11-cases", "cases": len(cases),
          "swept_cases": swept, "clusters": list(KGQ.CLUSTERS), "k": ks,
          "cuts_2048": GQ.gq_device(bm2k, 12)[0].tolist()})
    sweep = {c: time_ms(lambda: KGQ.gq_dp_cluster(bm2k, 12, c), reps=30)
             for c in KGQ.CLUSTERS}
    emit({"phase": "kernel-k11-sweep", "shape": [bm2k.shape[0], 12],
          "event_ms": sweep})

    bm = bm2k
    ms = time_ms(lambda: KGQ.gq_dp(bm, 12), reps=30)
    plain = time_ms(lambda: KGQ.gq_dp_plain(bm, 12), reps=3, warm=1)
    b = bm.shape[0]
    cand = sum(max(0, n - k + 1) for k in range(2, 13) for n in range(b + 1))
    nbytes = 4 * (b * 11 + (b + 1) * 11 + 12 * (b + 1) + 13 * (b + 1)
                  + 12 * 13)
    # the work the function needs: D(t, n) does not depend on the level,
    # so each of the b (b + 1) / 2 cells once (12 f32 operations: 5
    # differences, 3 products, 2 sums, the quotient, the difference), then
    # 2 a candidate (the level's sum, the compare), and the prefix's 11 b
    # sums, none fusable: at the instruction rate
    cells = b * (b + 1) // 2
    t_ops = (12 * cells + 2 * cand + 11 * b) / PEAK_F32_INSTR * 1e3
    t_chain = k11_chain_cycles(12, b) / sm_clock_hz() * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    parts = {"bytes": t_bytes, "operations": t_ops, "chain": t_chain}
    binding = max(parts, key=parts.get)
    rows.append(dict(name="gq_dp", shape=[b, 12], max_abs_err=0.0, ms=ms,
                     plain_ms=plain, library_ms=None, cluster_ms=sweep,
                     bound_ms=parts[binding],
                     # the chain is a bound of dependent operations
                     bound_by="bytes" if binding == "bytes"
                     else "operations",
                     bound_binding=binding, bound_parts_ms=parts,
                     dp_cells=cells,
                     dp_candidates=cand))


def _k2_feats(torch, colors, wm, cand, tab):
    """The bf16-rounded features K2 sums, op for op its plain version's
    (written out here: ``--split --root`` runs a parent's kernels)."""
    t = torch.cat([tab, torch.zeros((1, 8), device=DEV)])[cand.long()]
    x = colors - t[:, 0:3]
    wx = wm[:, None] * x
    wxx = wx * x
    return torch.cat(
        [wm[:, None], wx, ((wxx[:, 0] + wxx[:, 1]) + wxx[:, 2])[:, None]],
        dim=-1).to(torch.bfloat16).to(torch.float32)


# K9's split shapes (rows, cols): the 4K default call, a mesh-4 rank's strip
K9_SPLIT_SHAPES = ((H, W), (H // 4, W))


def phase_split(torch):
    """K1, K2, K4, K9, K3, K8, K7, K5, K6, K10 and K11 alone: CUDA-event ms of
    a wrapper call, the enqueue rate, each launch's device time
    (launch_split);
    index_add_ beside K1, and beside K2 on K2's own keys and precomputed
    features (a yardstick of its accumulate part only). K1 at K1_SHAPES,
    K4 at P = 256 and P_LARGE, K2 at the random case and at the LQ loop's
    median member share, K9 at K9_SPLIT_SHAPES, K3 on the synthetic 4K
    image and on random pixels, K8 at the default call's 4K shape, K7 at
    4K and at the 100 MP call's strip, K5 on the grid at P = 256 (u8) and
    1024 (u16), K6 on those two tables (v2 also on a quarter, v1 and u16
    also on a one-block table), K10 at each of K10_ROWS. It runs after
    every e2e phase: once torch.profiler has traced a process, each later
    launch in it
    pays CUPTI's cost on the host, which the LQ loop's laps would show.
    With ``--root DIR`` the kernels are another checkout's (a parent's,
    timed in turns with this one's)."""
    from patolette_tpu_torch.kernels.assign import assign_planar
    from patolette_tpu_torch.kernels.colorspace import color_convert
    from patolette_tpu_torch.kernels.kmeans import kmeans_step
    from patolette_tpu_torch.kernels.lq import (lq_candidates,
                                                lq_candidates_plain)
    from patolette_tpu_torch.kernels.lut import lut_argmin
    from patolette_tpu_torch.kernels.mbd import mbd
    from patolette_tpu_torch.kernels.segment import segment_sum
    from patolette_tpu_torch.ops import lut

    n = N_SAMPLES
    x = _working_pixels(torch, n, 1)
    for s, f, hi in K1_SHAPES:
        g = torch.Generator(device=DEV).manual_seed(s)
        ids = torch.randint(0, hi, (n,), generator=g, device=DEV,
                            dtype=torch.int32)
        feats = _k1_feats(torch, x, f)
        keep = ids < s
        idsk, featsk = ids[keep].long(), feats[keep].contiguous()
        def library():
            return torch.zeros((s, f), device=DEV).index_add_(0, idsk,
                                                              featsk)

        ms = time_ms(lambda: segment_sum(feats, ids, s), reps=30)
        lib = time_ms(library, reps=30)
        emit({"phase": "split", "kernel": "segment_sum", "shape": [n, s, f],
              "ms": ms, "library_ms": lib,
              "enqueue_ms": enqueue_ms(lambda: segment_sum(feats, ids, s)),
              "library_enqueue_ms": enqueue_ms(library),
              "split": launch_split(torch,
                                    lambda: segment_sum(feats, ids, s)),
              "library_split": launch_split(torch, library)})
    for p in (256, P_LARGE):
        g = torch.Generator(device=DEV).manual_seed(7)
        c0 = x[torch.randint(0, n, (p,), generator=g, device=DEV)].clone()
        valid = torch.ones(p, dtype=torch.bool, device=DEV)
        valid[-2:] = False
        reps = 30 if p == 256 else 5
        ms = time_ms(lambda: kmeans_step(x, None, c0, valid), reps=reps)
        emit({"phase": "split", "kernel": "kmeans_step", "shape": [n, p],
              "ms": ms, "enqueue_ms": enqueue_ms(
                  lambda: kmeans_step(x, None, c0, valid),
                  calls=100 if p == 256 else 5),
              "split": launch_split(
                  torch, lambda: kmeans_step(x, None, c0, valid),
                  reps=reps)})
    cases = k2_cases(torch)
    for name in ("random", "lq_loop_median"):
        args = cases[name]
        colors, wm, cand, tab, nb = args
        c = tab.shape[0]
        member = cand < c
        _, bucket = lq_candidates_plain(*args)
        keys = (cand.long() * nb + bucket.long())[member]
        featsk = _k2_feats(torch, colors, wm, cand, tab)[member].contiguous()
        def library():
            return torch.zeros((c * nb, 5), device=DEV).index_add_(
                0, keys, featsk)

        emit({"phase": "split", "kernel": "lq_candidates", "case": name,
              "shape": [cand.shape[0], c, nb],
              "member_share": int(member.sum()) / cand.shape[0],
              "ms": time_ms(lambda: lq_candidates(*args), reps=30),
              "enqueue_ms": enqueue_ms(lambda: lq_candidates(*args)),
              "split": launch_split(torch, lambda: lq_candidates(*args)),
              "library": "index_add_ of the precomputed features by key "
                         "(K2's accumulate part only)",
              "library_ms": time_ms(library, reps=30),
              "library_split": launch_split(torch, library)})
    for rows_, cols in K9_SPLIT_SHAPES:
        img = _mbd_image(torch, rows_, cols)
        emit({"phase": "split", "kernel": "mbd", "shape": [rows_, cols],
              "ms": time_ms(lambda: mbd(img)),
              "enqueue_ms": enqueue_ms(lambda: mbd(img), calls=10),
              "split": launch_split(torch, lambda: mbd(img), reps=5)})
    for kind in ("image", "random"):
        _, chans, centers, valid = _k3_inputs(torch, kind)
        emit({"phase": "split", "kernel": "assign_planar", "case": kind,
              "shape": [W * H, 256],
              "ms": time_ms(lambda: assign_planar(chans, centers, valid)),
              "split": launch_split(
                  torch, lambda: assign_planar(chans, centers, valid),
                  reps=10)})
    del chans
    from patolette_tpu_torch.kernels.dither import dither_scan, palette_table
    from patolette_tpu_torch.ops import hilbert

    ch = _linear_image(torch, W, H)
    table = palette_table(*_k8_palette(torch, ch, 256, "random"))
    perm = hilbert.pixel_visit_order(W, H, DEV)
    emit({"phase": "split", "kernel": "dither_scan",
          "shape": [W * H, 256, 4096],
          "ms": time_ms(lambda: dither_scan(ch, perm, table, 4096)),
          "split": launch_split(
              torch, lambda: dither_scan(ch, perm, table, 4096), reps=10)})
    del ch, perm
    # K7: the whole visit order (the parent: keys, a torch argsort, a cast)
    for w, h in _k7_shapes()[:2]:
        emit({"phase": "split", "kernel": "visit_order", "shape": [w, h],
              "ms": time_ms(lambda: hilbert.pixel_visit_order(w, h, DEV),
                            reps=30),
              "enqueue_ms": enqueue_ms(
                  lambda: hilbert.pixel_visit_order(w, h, DEV)),
              "split": launch_split(
                  torch, lambda: hilbert.pixel_visit_order(w, h, DEV))})
    grid = lut.grid_ictcp(2, DEV)
    tables = {}
    for p, dtype in ((256, torch.uint8), (1024, torch.uint16)):
        centers = _working_pixels(torch, p, 20 + p)
        valid = torch.ones(p, dtype=torch.bool, device=DEV)
        valid[-3:] = False
        emit({"phase": "split", "kernel": "lut_argmin",
              "shape": [lut.LUT_SIZE, p],
              "ms": time_ms(lambda: lut_argmin(grid, centers, valid, dtype)),
              "split": launch_split(
                  torch, lambda: lut_argmin(grid, centers, valid, dtype),
                  reps=10)})
        tables[p] = lut_argmin(grid, centers, valid, dtype)
    del grid
    lut.clear_grid_cache()
    # K6 in its three formats on K5's tables, the quarter slice and the
    # one-block tables (the kernels phase's)
    from patolette_tpu_torch.kernels import rle

    n = lut.LUT_SIZE
    for name, fn, t in (
            ("rle_encode_u8_v2", rle.rle_encode_u8_v2, tables[256]),
            ("rle_encode_u8_v2[quarter]", rle.rle_encode_u8_v2,
             tables[256][n // 4:n // 2]),
            ("rle_encode_u8", rle.rle_encode_u8, tables[256]),
            ("rle_encode_u8[block]", rle.rle_encode_u8,
             _block_table(torch, n, torch.uint8)),
            ("rle_encode_u16_v2", rle.rle_encode_u16_v2, tables[1024]),
            ("rle_encode_u16_v2[block]", rle.rle_encode_u16_v2,
             _block_table(torch, n, torch.uint16))):
        emit({"phase": "split", "kernel": name, "shape": [t.shape[0]],
              "ms": time_ms(lambda: fn(t), reps=30),
              "enqueue_ms": enqueue_ms(lambda: fn(t)),
              "split": launch_split(torch, lambda: fn(t))})
    del tables
    inputs = _k10_inputs(torch)
    for name, kind, target, c, _, _ in K10_ROWS:
        x = inputs[kind]
        emit({"phase": "split", "kernel": "color_convert", "case": name,
              "ms": time_ms(lambda: color_convert(x, c, target)),
              "split": launch_split(
                  torch, lambda: color_convert(x, c, target), reps=10)})
    # K11, where the package has it (a parent may not)
    if importlib.util.find_spec("patolette_tpu_torch.kernels.gq"):
        from patolette_tpu_torch.kernels.gq import gq_dp

        bm = image_bucket_moments(torch, ONE_SHOT_W, ONE_SHOT_H)
        emit({"phase": "split", "kernel": "gq_dp", "shape": [512, 12],
              "ms": time_ms(lambda: gq_dp(bm, 12), reps=30),
              "enqueue_ms": enqueue_ms(lambda: gq_dp(bm, 12)),
              "split": launch_split(torch, lambda: gq_dp(bm, 12))})
        # the cluster sweep, where the package has it
        from patolette_tpu_torch.kernels import gq as KGQ

        for c in getattr(KGQ, "CLUSTERS", ()):
            emit({"phase": "split", "kernel": "gq_dp", "cluster": c,
                  "shape": [512, 12],
                  "ms": time_ms(lambda: KGQ.gq_dp_cluster(bm, 12, c),
                                reps=30),
                  "split": launch_split(
                      torch, lambda: KGQ.gq_dp_cluster(bm, 12, c))})


LAPS_ROUNDS = 8


def phase_laps(torch, rounds=LAPS_ROUNDS):
    """The walls and laps of the 4K uint8 LUT call, the 4K default call,
    bench.py's headline call (100 MP uint8), the same image dithered on
    strips (strip-headline) and the two 2048x2048 calls of e2e-one-shot
    (the one-shot route; a parent without it runs them resident), each
    warmed up, then
    ``rounds`` rounds of one plain call (wall, laps) and one synced call
    (laps) of each, the calls in turns. With ``--root DIR`` on another
    checkout's package (a parent's), so that two trees can run in turns, a
    process each, in one call to the card."""
    import numpy as np

    import patolette_tpu_torch as pt
    from patolette_tpu_torch.models import pipeline

    img = synth_image_f32(W, H)
    calls = {
        "e2e-u8-lut": (np.round(img * 255.0).astype(np.uint8),
                       dict(dither=False, tile_size=0, kmeans_niter=32,
                            color_space=pt.ColorSpace_ICtCp)),
        "e2e-default": (img, {}),
        "e2e-headline": (synth_image_u8(HEADLINE_W, HEADLINE_H),
                         dict(dither=False, tile_size=0, kmeans_niter=25,
                              color_space=pt.ColorSpace_ICtCp)),
    }
    calls["e2e-strip-headline"] = (calls["e2e-headline"][0],
                                   dict(dither=True, tile_size=0,
                                        kmeans_niter=25))
    img2k = synth_image_f32(ONE_SHOT_W, ONE_SHOT_H)
    calls["e2e-one-shot"] = (img2k, dict(dither=False, tile_size=0,
                                         kmeans_niter=32,
                                         color_space=pt.ColorSpace_ICtCp))
    calls["e2e-one-shot-default"] = (img2k, {})
    shapes = {"e2e-headline": (HEADLINE_W, HEADLINE_H),
              "e2e-strip-headline": (HEADLINE_W, HEADLINE_H),
              "e2e-one-shot": (ONE_SHOT_W, ONE_SHOT_H),
              "e2e-one-shot-default": (ONE_SHOT_W, ONE_SHOT_H)}

    def run(name, **extra):
        colors, kw = calls[name]
        w, h = shapes.get(name, (W, H))
        t0 = time.perf_counter()
        ok, _, _, msg = pt.quantize(w, h, colors, 256, **kw, **extra)
        wall = time.perf_counter() - t0
        check(ok, f"{name} failed: {msg}")
        return wall, dict(pipeline.LAST_STAGE_TIMES)

    for name in calls:
        run(name)
        run(name)
    laps = ("lq", "gq-dp", "saliency", "sample-in", "lut-build",
            "lut-build+pull", "palette+lut-build", "lut-pull",
            "lut-map-host", "palette (device)", "dither", "nn-map",
            "palette", "one-shot")
    out = {name: {k: [] for k in ("wall_s", *laps,
                                  *(f"{lap}_synced" for lap in laps))}
           for name in calls}
    for _ in range(rounds):
        for name in calls:
            wall, plain = run(name)
            _, synced = run(name, sync_stages=True)
            r = out[name]
            r["wall_s"].append(wall)
            for lap in laps:
                if lap in plain:
                    r[lap].append(plain[lap])
                    r[f"{lap}_synced"].append(synced[lap])
    for name, r in out.items():
        r = {k: v for k, v in r.items() if v}
        emit({"phase": "laps", "call": name, "rounds": rounds,
              "package": str(pathlib.Path(pt.__file__).parent.parent), **r,
              "median": {k: statistics.median(v) for k, v in r.items()}})


SPAN_CALLS = 6
# Runtime calls that submit work to the card (a graph launch is one) and
# runtime calls in which the host waits for it, by name without the CUPTI
# version or per-thread suffix.
SUBMITS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
    "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
    "cudaMemcpy2DAsync", "cudaMemsetAsync", "cuMemcpyAsync",
    "cuMemcpyHtoDAsync", "cuMemcpyDtoHAsync", "cuMemsetD8Async",
    "cuMemsetD32Async", "cudaGraphLaunch", "cuGraphLaunch"})
WAITS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})


def _runtime_name(name):
    return re.sub(r"(_pt(sz|ds))?(_v\d+)?$", "", name)


def span_readings(call, events, laps, core):
    """The stage spans of one traced call and what they hold, from the
    profiler's Chrome events (``call``: the call's range; ``events``:
    (start, end, name, category, correlation) of every event of the
    trace). ``laps``: the call's lap names in order;
    ``core``: the laps of the palette core. Returns the readings and a list
    of what does not hold: one ``patolette/<lap>`` range a lap, in lap
    order, disjoint, inside the call; one ``patolette/lq-loop`` inside a
    span of the palette core."""
    from patolette_tpu_torch.utils.spans import PREFIX

    c0, c1 = call

    def inside(s, iv):
        return any(a <= s <= b for a, b in iv)

    spans = sorted((s, e, n[len(PREFIX):]) for s, e, n, cat, _ in events
                   if cat == "user_annotation" and n.startswith(PREFIX)
                   and c0 <= s <= c1)
    stages = [x for x in spans if x[2] != "lq-loop"]
    loops = [(s, e) for s, e, n in spans if n == "lq-loop"]
    core_iv = [(s, e) for s, e, n in stages if n in core]
    faults = []
    if [n for _, _, n in stages] != list(laps):
        faults.append(f"spans {[n for _, _, n in stages]} != laps {laps}")
    if any(e > s2 for (_, e, _), (s2, _, _) in zip(stages, stages[1:])) \
            or any(e > c1 for _, e, _ in stages):
        faults.append("stage spans overlap or leave the call")
    if len(loops) != 1 or not any(a <= loops[0][0] and loops[0][1] <= b
                                  for a, b in core_iv):
        faults.append(f"lq-loop spans {loops}, palette core {core_iv}")
    runtime = [(s, _runtime_name(n), corr) for s, e, n, cat, corr in events
               if cat in ("cuda_runtime", "cuda_driver") and c0 <= s <= c1]
    device = [(s, e, corr) for s, e, n, cat, corr in events
              if cat in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sorted((s, e) for s, e, _ in device)
    idle = 0.0
    for a, b in core_iv:
        t = a
        for s, e in busy:
            if e <= t or s >= b:
                continue
            idle += max(0.0, s - t)
            t = max(t, min(e, b))
        idle += max(0.0, b - t)
    mine = {corr for s, _, corr in runtime if inside(s, core_iv)}
    work, dev_us, t = sorted((s, e) for s, e, c in device if c in mine), \
        0.0, float("-inf")
    for s, e in work:
        dev_us += max(0.0, e - max(s, t))
        t = max(t, e)
    in_loop = collections.Counter(n for s, n, _ in runtime
                                  if inside(s, loops))
    launched = {corr for _, _, corr in runtime}
    return {
        "palette_idle_ms": idle * 1e-3,
        "palette_device_ms": dev_us * 1e-3,
        "lq_launches": sum(v for n, v in in_loop.items() if n in SUBMITS),
        "host_syncs": sum(n in WAITS for _, n, _ in runtime),
        "host_syncs_by_lap": dict(collections.Counter(
            next((n for a, b, n in stages if a <= s <= b), "-")
            for s, name, _ in runtime if name in WAITS)),
        "lq_runtime_calls": dict(in_loop.most_common(8)),
        "runtime_calls": len(runtime),
        # work that starts in this call but was launched outside it: the
        # card's timestamps drifting against the host's
        "device_unmatched": sum(c0 <= s <= c1 and c not in launched
                                for s, _, c in device),
    }, faults


def _span_cost_us(torch, reps=20000):
    """Host microseconds of one empty ``span`` with no profiler, and
    under a profiler with CPU and CUDA activity (the traced pass's)."""
    from torch.profiler import ProfilerActivity, profile

    from patolette_tpu_torch.utils.spans import span

    def per_span():
        t0 = time.perf_counter()
        for _ in range(reps):
            with span("cost-probe"):
                pass
        return (time.perf_counter() - t0) * 1e6 / reps

    off = per_span()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = per_span()
    return {"off": off, "profiled": on}


def phase_spans(torch):
    """The three benchmark cells' calls (the default call at 3840x2160 and
    2048x2048 float32, the 8-bit export call at 3840x2160 uint8), each
    warmed, then ``SPAN_CALLS`` calls untimed by the profiler (walls), then,
    after every cell's, ``SPAN_CALLS`` traced calls a cell under
    torch.profiler with CPU and CUDA activity: each call's walls, its stage
    spans checked (``span_readings``) and the palette core's idle and
    device ms, the LQ loop's submissions and the host waits read from the
    trace. With ``--root DIR`` on another checkout's package (a parent
    without spans reads only its waits and walls)."""
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    import patolette_tpu_torch as pt
    from patolette_tpu_torch.models import pipeline

    has_spans = importlib.util.find_spec(
        "patolette_tpu_torch.utils.spans") is not None
    core = {"gq-moments", "gq-dp", "lq", "kmeans", "palette",
            "palette+lut-build", "palette (device)", "palette (sharded)",
            "palette-out", "saliency+palette+lut-build"}
    img4k = synth_image_f32(W, H)
    cells = {
        "default-4k": (W, H, img4k, {}),
        "export-4k": (W, H, np.round(img4k * 255.0).astype(np.uint8),
                      dict(dither=False, tile_size=0, kmeans_niter=25,
                           color_space=pt.ColorSpace_ICtCp)),
        "default-2k": (ONE_SHOT_W, ONE_SHOT_H,
                       synth_image_f32(ONE_SHOT_W, ONE_SHOT_H), {}),
    }

    def run(name):
        w, h, colors, kw = cells[name]
        t0 = time.perf_counter()
        ok, _, _, msg = pt.quantize(w, h, colors, 256, **kw)
        wall = (time.perf_counter() - t0) * 1e3
        check(ok, f"{name} failed: {msg}")
        return wall, list(pipeline.LAST_STAGE_TIMES)

    out = {name: {"wall_ms": []} for name in cells}
    for name in cells:
        run(name)
        run(name)
        out[name]["wall_ms"] = [run(name)[0] for _ in range(SPAN_CALLS)]
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if has_spans:
        emit({"phase": "spans-cost", "us_a_span": _span_cost_us(torch)})
    for name in cells:
        laps = []
        with profile(activities=acts) as prof:
            for i in range(SPAN_CALLS):
                with record_function(f"spans_call_{i}"):
                    laps.append(run(name))
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)["traceEvents"]
        events = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e.get("name", ""), e.get("cat", ""),
                   (e.get("args") or {}).get("correlation"))
                  for e in raw if e.get("ph") == "X"]
        calls = sorted((s, e, int(n[len("spans_call_"):]))
                       for s, e, n, cat, _ in events
                       if cat == "user_annotation"
                       and n.startswith("spans_call_"))
        r = out[name]
        r["traced_wall_ms"] = [lap[0] for lap in laps]
        r["traced_range_ms"] = [(e - s) * 1e-3 for s, e, _ in calls]
        for s, e, i in calls:
            if has_spans:
                got, faults = span_readings((s, e), events, laps[i][1],
                                            core)
                check(not faults, f"{name} call {i}: {faults}")
            else:
                got = {"host_syncs": sum(
                    _runtime_name(n) in WAITS for s2, _, n, cat, _ in events
                    if cat == "cuda_runtime" and s <= s2 <= e)}
            for k, v in got.items():
                r.setdefault(k, []).append(v)
        del raw, events, prof
    for name, r in out.items():
        emit({"phase": "spans", "call": name, "spans": has_spans,
              "package": str(pathlib.Path(pt.__file__).parent.parent), **r,
              "median": {k: statistics.median(v) for k, v in r.items()
                         if v and not isinstance(v[0], dict)}})


LQ_GRAPH_CALLS = 8


# The --lq-graph phase's calls: a benchmark cell, and what is changed in
# its traffic (width, height) or call (palette_size).
LQ_GRAPH_CASES = {
    "default-4k": ("default-4k", {}),
    "export-4k": ("export-4k", {}),
    "default-2k": ("default-2k", {}),
    # under the LQ sample's 2^18 pixels, weighted and not
    "default-320": ("default-4k", dict(width=320, height=240)),
    "export-320": ("export-4k", dict(width=320, height=240)),
    # int32 labels, ~4x the rounds
    "export-4k-1024": ("export-4k", dict(palette_size=1024)),
}


def _cell_call(name, count=4):
    """A case of ``LQ_GRAPH_CASES`` as ``portbench/run.py`` calls its cell
    (the cell's configuration and traffic files; images made on the card
    from seed 0): (width, height, palette size, images, the call's other
    arguments)."""
    from patolette_tpu_torch.utils.config import ColorSpace
    from portbench.harness import images as gen
    from portbench.harness import manifest

    workload, changes = LQ_GRAPH_CASES[name]
    cell = manifest.cell(manifest.load_benchmark(), workload)
    call = dict(cell["config"]["call"])
    call.update((k, v) for k, v in changes.items() if k in call)
    tr = dict(cell["traffic"], images=count)
    tr.update((k, v) for k, v in changes.items() if k not in call)
    p = int(call.pop("palette_size"))
    call["color_space"] = ColorSpace[call["color_space"]]
    return (int(tr["width"]), int(tr["height"]), p,
            gen.make_images(tr, cell["config"]["input_dtype"], 0, DEV), call)


def phase_lq_graph(torch):
    """The LQ loop's graph (``local_q.lq_quantize``). Each benchmark
    cell's call on its four images: two warm calls, then
    ``LQ_GRAPH_CALLS`` calls' walls, palette-core laps, peak allocated and
    reserved device memory, ``LQ_GRAPH`` and the graphs' held bytes
    (``lq-graph-cell`` lines). Then the loop's inputs of every call of each
    case of ``LQ_GRAPH_CASES``, caught by a spy: each input's eager loop
    (``lq_loop``) against the cached graph, captured on the first and
    replayed on all four, capture and replays under sync debug mode
    "error", labels and count bit for bit, and the device memory the
    capture reserved (``lq-graph-check`` lines)."""
    import patolette_tpu_torch as pt
    from patolette_tpu_torch.models import local_q, pipeline

    core = ("gq-moments", "gq-dp", "lq", "kmeans", "palette",
            "palette+lut-build", "palette (device)", "palette-out")
    for name in ("default-4k", "export-4k", "default-2k"):
        w, h, p, imgs, kw = _cell_call(name)

        def run(i):
            t0 = time.perf_counter()
            ok, _, _, msg = pt.quantize(w, h, imgs[i % len(imgs)], p,
                                         device=DEV, **kw)
            check(ok, f"{name} failed: {msg}")
            return (time.perf_counter() - t0) * 1e3

        local_q.clear_lq_graphs()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        warm = [run(0), run(1)]   # the key's eager call, then its capture
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        local_q.reset_lq_graph()
        walls, core_ms = [], []
        for i in range(LQ_GRAPH_CALLS):
            walls.append(run(i))
            core_ms.append(sum(v for k, v in pipeline.LAST_STAGE_TIMES.items()
                               if k in core))
        torch.cuda.synchronize()
        held = local_q.graph_bytes()
        emit({"phase": "lq-graph-cell", "call": name,
              "warm_ms": warm, "wall_ms": walls, "palette_host_ms": core_ms,
              "median_wall_ms": statistics.median(walls),
              "median_palette_host_ms": statistics.median(core_ms),
              "max_allocated_mb": torch.cuda.max_memory_allocated() / 1e6,
              "max_reserved_mb": torch.cuda.max_memory_reserved() / 1e6,
              "graph_bytes": held, "lq_graph": dict(local_q.LQ_GRAPH)})
        check(held <= pipeline.LQ_GRAPH_BYTES,
              f"{name}: the graphs hold {held} B")
        del imgs

    real = local_q.lq_quantize
    for name in LQ_GRAPH_CASES:
        w, h, p, imgs, kw = _cell_call(name)
        caught = []

        def spy(colors, weights, init_labels, k0, palette_size, **kw2):
            caught.append((
                colors.clone(),
                None if weights is None else weights.clone(),
                init_labels.clone(),
                k0.clone() if isinstance(k0, torch.Tensor) else k0,
                palette_size, kw2))
            return real(colors, weights, init_labels, k0, palette_size,
                        **kw2)

        local_q.lq_quantize = spy
        try:
            for img in imgs:
                ok, _, _, msg = pt.quantize(w, h, img, p, device=DEV, **kw)
                check(ok, f"{name} failed: {msg}")
        finally:
            local_q.lq_quantize = real
        del imgs
        keys = {(a[0].shape[0], a[1] is not None, a[4],
                 tuple(sorted(a[5].items()))) for a in caught}
        check(len(caught) == 4 and len(keys) == 1,
              f"{name}: {len(caught)} LQ calls, keys {keys}")
        eager = [local_q.lq_loop(*a[:5], **a[5]) for a in caught]
        local_q.clear_lq_graphs()
        local_q.reset_lq_graph()
        local_q.lq_quantize(*caught[0][:5], **caught[0][5])   # first sight
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            local_q.lq_quantize(*caught[0][:5], **caught[0][5])   # capture
            t1 = time.perf_counter()
            got = [local_q.lq_quantize(*a[:5], **a[5]) for a in caught]
            t2 = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        same = [bool(torch.equal(g[0], e[0]) and torch.equal(g[1], e[1]))
                for g, e in zip(got, eager)]
        # the outputs of consecutive calls are copies, not the graph's own
        apart = len({g[0].data_ptr() for g in got}) == len(got)
        counts = local_q.LQ_GRAPH
        emit({"phase": "lq-graph-check", "call": name,
              "n": caught[0][0].shape[0], "p": p,
              "weighted": caught[0][1] is not None,
              "k0": [int(a[3]) for a in caught],
              "count": [int(g[1]) for g in got], "same": same,
              # host time: capture, instantiation and one replay's enqueue;
              # a replay's enqueue
              "capture_call_host_ms": (t1 - t0) * 1e3,
              "replay_call_host_ms": (t2 - t1) * 1e3 / len(caught),
              # the graph's pool and the inputs' segments
              "capture_reserved_mb": (torch.cuda.memory_reserved()
                                      - reserved) / 1e6,
              "graph_bytes": local_q.graph_bytes(),
              "apart": apart, "lq_graph": dict(counts)})
        check(all(same), f"{name}: replay differs from the eager loop")
        check(apart, f"{name}: replayed outputs share memory")
        check(counts == {"eager": 1, "captured": 1,
                         "replayed": 1 + len(caught)},
              f"{name}: LQ_GRAPH {counts}")
    local_q.clear_lq_graphs()
    check(local_q.graph_bytes() == 0, "cleared graphs still hold inputs")


def phase_kernels(torch):
    from patolette_tpu_torch.kernels import build

    rows = []
    kernel_k1(torch, rows)
    kernel_k1_adversarial(torch)
    kernel_k2(torch, rows)
    kernel_k3(torch, rows)
    kernel_k3_cases(torch)
    kernel_k4(torch, rows)
    kernel_k4_adversarial(torch)
    kernel_k4_large(torch, rows)
    tables = kernel_k5(torch, rows)
    kernel_k6(torch, rows)
    kernel_k6_pull(torch, rows, tables)
    kernel_k6_cases(torch)
    kernel_k7(torch, rows)
    kernel_k8(torch, rows)
    kernel_k8_cases(torch)
    kernel_k9(torch, rows)
    kernel_k10(torch, rows)
    kernel_k11(torch, rows)
    # the e2e phases' peak device memory counts what their calls hold
    build.clear_scratch()
    for r in rows:
        emit(dict(phase="kernel", **r))
    return rows, tables


def _pull_stages(torch, t):
    """Where pull_lut's time goes on a table whose first format does not
    overflow: medians of the encode (to its end on the card), the header
    read, the copy of the words, the host buffer's allocation and the
    decode into that fresh buffer, each on the host clock, PULL_PAIRS
    times; beside them the same decode into a buffer whose pages were
    touched first (``decode_prefaulted``) and the words' copy into such a
    buffer of the table's size from the card (``raw_prefaulted``), which
    separate the decode's own work from the first touch of its pages."""
    import numpy as np

    from patolette_tpu_torch.kernels import rle
    from patolette_tpu_torch.ops import lut

    if t.dtype == torch.uint8:
        encode, read, hdr = rle.rle_encode_u8_v2, rle.header, 3
        decode, dtype = lut.rle_decode_u8_v2, np.uint8
    else:
        encode, read, hdr = rle.rle_encode_u16_v2, rle.header_u16_v2, 2
        decode, dtype = lut.rle_decode_u16_v2, np.uint16
    names = ("encode", "header", "words", "alloc", "decode")
    stages = {k: [] for k in names + ("decode_prefaulted", "raw_prefaulted")}
    for _ in range(PULL_PAIRS):
        torch.cuda.synchronize()
        ts = [time.perf_counter()]
        enc = encode(t)
        torch.cuda.synchronize()
        ts.append(time.perf_counter())
        count, over = read(enc)
        ts.append(time.perf_counter())
        check(not over, "pull stages: the table overflows")
        words = enc[hdr:hdr + count].cpu().numpy()
        ts.append(time.perf_counter())
        buf = np.empty((t.shape[0],), dtype)
        ts.append(time.perf_counter())
        decode(words, buf)
        ts.append(time.perf_counter())
        for k, a, b in zip(names, ts, ts[1:]):
            stages[k].append((b - a) * 1e3)
        warm = np.empty((t.shape[0],), dtype)
        warm.fill(1)
        t0 = time.perf_counter()
        decode(words, warm)
        stages["decode_prefaulted"].append((time.perf_counter() - t0) * 1e3)
        check(np.array_equal(warm, buf), "pull stages: decodes differ")
        warm_t = torch.from_numpy(warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm_t.copy_(t)
        stages["raw_prefaulted"].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in stages.items()}


# pull_lut's branches: table -> the K6 kernels it must launch, in order
PULL_BRANCHES = (
    ("u8-v2", ("rle_encode_u8_v2",)),
    ("u8-v1", ("rle_encode_u8_v2", "rle_encode_u8")),
    ("u8-raw", ("rle_encode_u8_v2", "rle_encode_u8")),
    ("u16-v2", ("rle_encode_u16_v2",)),
    ("u16-raw", ("rle_encode_u16_v2",)),
)
PULL_PAIRS = 10


def phase_pull(torch, tables):
    """The table pull (``ops/lut.py::pull_lut``) on device tables, one for
    each branch: K5's 256-colour table (u8 v2), the one-block table (v2
    overflows, v1), the alternating table (v1 over its cap, raw), K5's
    1024-colour table (u16 v2), the one-block u16 table (raw). Each pull
    must equal the table bit for bit and launch the K6 kernels of its
    branch and no other. Then the raw copy (``.cpu()``) against pull_lut
    on K5's two tables, in turns (raw, pull, raw, pull, ...), medians."""
    from patolette_tpu_torch import kernels
    from patolette_tpu_torch.ops import lut

    n = lut.LUT_SIZE
    k6 = ("rle_encode_u8_v2", "rle_encode_u8", "rle_encode_u16_v2")
    inputs = {
        "u8-v2": tables[256],
        "u8-v1": _block_table(torch, n, torch.uint8),
        "u8-raw": torch.arange(n, device=DEV).remainder(2).to(torch.uint8),
        "u16-v2": tables[1024],
        "u16-raw": _block_table(torch, n, torch.uint16),
    }
    out = {"phase": "pull", "branches": {}}
    launches = {}
    for branch, expect in PULL_BRANCHES:
        t = inputs[branch]
        reset_launches()
        got = lut.pull_lut(t)
        launched = {k: kernels.LAUNCHES[k] for k in k6}
        launches[branch] = dict(kernels.LAUNCHES)
        check(got.dtype == t.cpu().numpy().dtype
              and (got == t.cpu().numpy()).all(),
              f"pull {branch}: the table differs")
        check(launched == {k: int(k in expect) for k in k6},
              f"pull {branch}: launched {launched}")
        out["branches"][branch] = launched
    for p, t in ((256, tables[256]), (1024, tables[1024])):
        raw, enc = [], []
        for _ in range(PULL_PAIRS):
            for times, fn in ((raw, lambda: t.cpu().numpy()),
                              (enc, lambda: lut.pull_lut(t))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        out[f"p{p}"] = {"raw_ms": raw, "pull_lut_ms": enc,
                        "raw_median_ms": statistics.median(raw),
                        "pull_lut_median_ms": statistics.median(enc),
                        "pull_lut_stages_median_ms": _pull_stages(torch, t)}
    emit(out)
    return {"pull-" + b: v for b, v in launches.items()}


def synth_image_f32(w, h, seed=0, tile=1000):
    """The texture of bench.py's synthetic image, kept in float32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:tile, 0:tile].astype(np.float32)
    pat = np.stack(
        [
            0.5 + 0.45 * np.sin(xx / 97.0) * np.cos(yy / 131.0),
            0.5 + 0.45 * np.cos(xx / 177.0 + yy / 211.0),
            0.5 + 0.05 * rng.standard_normal((tile, tile)).astype(
                np.float32),
        ],
        axis=-1,
    )
    img = np.tile(pat, (-(-h // tile), -(-w // tile), 1))[:h, :w]
    img[:, :, 2] += np.linspace(-0.45, 0.45, h, dtype=np.float32)[:, None]
    return np.clip(img, 0, 1, out=img).reshape(-1, 3)


def synth_image_u8(w, h, seed=0, tile=1000):
    """bench.py's synthetic image (its ``synth_image_u8``): the texture on
    a small tile, tiled up, a full-size vertical gradient and noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:tile, 0:tile].astype(np.float32)
    pat = np.stack(
        [
            0.5 + 0.45 * np.sin(xx / 97.0) * np.cos(yy / 131.0),
            0.5 + 0.45 * np.cos(xx / 177.0 + yy / 211.0),
            0.5 + 0.05 * rng.standard_normal((tile, tile)).astype(np.float32),
        ],
        axis=-1,
    )
    reps_y, reps_x = -(-h // tile), -(-w // tile)
    img = np.tile(pat, (reps_y, reps_x, 1))[:h, :w]
    img[:, :, 2] += np.linspace(-0.45, 0.45, h, dtype=np.float32)[:, None]
    img = np.clip(img, 0, 1, out=img).reshape(-1, 3)
    return np.round(img * 255.0).astype(np.uint8)


def _mse_luv(torch, colors, pal, pmap):
    """CIELuv MSE of ``pal[pmap]`` against the image, and of the image
    snapped to the 216-colour uniform sRGB cube (the yardstick a 256-colour
    palette must beat by far)."""
    from patolette_tpu_torch.ops import colorspace as cs

    x = torch.from_numpy(colors.astype("float32")).to(DEV)
    p = torch.from_numpy(pal.astype("float32")).to(DEV)
    idx = torch.from_numpy(pmap.astype("int64")).to(DEV)
    a = cs.srgb_to_working(x, 1)
    b = cs.srgb_to_working(p, 1)[idx]
    cube = cs.srgb_to_working(torch.round(x * 5.0) / 5.0, 1)
    return (float(((a - b) ** 2).sum(-1).mean()),
            float(((a - cube) ** 2).sum(-1).mean()))


def _golden_image(w=96, h=64, seed=11):
    """The input of tests/test_golden.py."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack(
        [
            0.5 + 0.45 * np.sin(xx / 9.0) * np.cos(yy / 13.0),
            0.5 + 0.45 * np.cos(xx / 17.0),
            np.clip(yy / h + 0.08 * rng.standard_normal((h, w)), 0, 1),
        ],
        axis=-1,
    )
    return np.clip(img, 0, 1).reshape(-1, 3)


def _profile_call(torch, call, name):
    """One traced call: device busy share and the kernels by device time
    (torch.profiler, CUDA activity); the table goes to ``--out``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events (kernels, copies), without the profiler's own
    # "Activity Buffer Request" entry
    events = [e for e in prof.key_averages()
              if "CUDA" in str(getattr(e, "device_type", ""))
              and not e.key.startswith("Activity Buffer")]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    out_dir = _out_dir()
    if out_dir is not None:
        (out_dir / f"profile_{name}.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40))
    emit({"phase": "profile", "call": name, "wall_ms": wall_us / 1e3,
          "device_ms": device_us / 1e3,
          "device_busy_share": device_us / wall_us,
          "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                  for e in top],
          "top_host": [[e.key[:60], e.count, e.self_cpu_time_total / 1e3]
                       for e in sorted(prof.key_averages(),
                                       key=lambda e: -e.self_cpu_time_total)
                       [:8]]})


def reset_launches():
    """``kernels.reset_launches()``, and the LQ graphs forgotten: a
    replayed loop runs no kernel wrapper, so the next call of each key runs
    the loop eagerly and its K1 and K2 launches count."""
    from patolette_tpu_torch import kernels
    from patolette_tpu_torch.models import local_q

    kernels.reset_launches()
    local_q.clear_lq_graphs()


# Kernels each path must launch (names of kernels.LAUNCHES).
MAIN_PATH_KERNELS = ("segment_sum", "lq_candidates", "assign_planar",
                     "kmeans_step", "color_convert")
U8_LUT_KERNELS = ("lut_argmin", "rle_encode_u8_v2", "gq_dp", "segment_sum",
                  "lq_candidates", "kmeans_step", "color_convert")
DEFAULT_PATH_KERNELS = ("visit_order", "dither_scan", "mbd", "segment_sum",
                        "lq_candidates", "kmeans_step", "color_convert")
STRIP_DITHER_KERNELS = ("visit_order", "dither_scan", "color_convert",
                        "gq_dp", "segment_sum", "lq_candidates",
                        "kmeans_step")
OVER_BUDGET_KERNELS = ("color_convert", "gq_dp", "segment_sum",
                       "lq_candidates", "assign_planar", "kmeans_step")
# the opt-in full-image fused LUT route (PATOLETTE_FUSED_IMAGE_LUT=1) with
# saliency
IMAGE_LUT_KERNELS = ("mbd", "color_convert", "gq_dp", "segment_sum",
                     "lq_candidates", "kmeans_step", "lut_argmin",
                     "rle_encode_u8_v2")


def _drive(torch, run, colors, path_kernels, what):
    """Warm up, then one call between a reset and a read of the launch
    counts (each kernel of the path must have launched), then two more
    timed calls that must give the same bits, then one with synced laps."""
    import numpy as np

    from patolette_tpu_torch import kernels
    from patolette_tpu_torch.models import pipeline

    t0 = time.perf_counter()
    run(colors)
    warm_s = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    pal, pmap = run(colors)
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name in path_kernels:
        check(launches[name] > 0, f"kernel {name} not launched on {what}")
    walls, laps = [first_s], [dict(pipeline.LAST_STAGE_TIMES)]
    for _ in range(2):
        t0 = time.perf_counter()
        pal2, pmap2 = run(colors)
        walls.append(time.perf_counter() - t0)
        laps.append(dict(pipeline.LAST_STAGE_TIMES))
        check(np.array_equal(pal, pal2) and np.array_equal(pmap, pmap2),
              f"two runs of {what} differ")
    torch.cuda.reset_peak_memory_stats()
    run(colors, sync_stages=True)
    synced = dict(pipeline.LAST_STAGE_TIMES)
    peak = torch.cuda.max_memory_allocated()
    best = min(walls)
    return pal, pmap, dict(
        warmup_s=warm_s, wall_s=walls, best_s=best,
        stage_ms=laps[walls.index(best)], stage_ms_synced=synced,
        launches=launches, peak_device_bytes=peak)


def _check_footprint(stats, n, name):
    """Peak device bytes of a call held to the budget's footprint model of
    its route: the pipeline's constant of that name a pixel, and what the LQ
    graphs hold from call to call (``pipeline.LQ_GRAPH_BYTES``, whatever
    N). Returns the peak's bytes per pixel."""
    from patolette_tpu_torch.models import pipeline

    peak = stats["peak_device_bytes"]
    limit = getattr(pipeline, name)
    check(peak <= n * limit + pipeline.LQ_GRAPH_BYTES,
          f"peak {peak} B above {name} = {limit} a pixel and the LQ "
          f"graphs' {pipeline.LQ_GRAPH_BYTES} B")
    return peak / n


def _check_outputs(pal, pmap, p, n):
    import numpy as np

    check(pal.shape == (p, 3) and pmap.shape == (n,), "bad shapes")
    check(pmap.dtype == np.int32 and pmap.min() >= 0 and pmap.max() < p,
          "bad map")
    used = pal[:, 0] >= 0
    check(np.isfinite(pal).all() and (pal[used] <= 1).all()
          and (pal[used] >= 0).all() and used[np.unique(pmap)].all(),
          "bad palette")
    return int(used.sum())


def _program_palette(torch, colors, p, niter, seed=1234):
    """The working-space palette (centres, valid) the fused sampled and
    the streamed routes search for ``colors`` at their defaults: the
    route's host draws, then the palette program (K10, K1, K11, K2,
    K4)."""
    from patolette_tpu_torch.models import pipeline

    dev = torch.device(DEV, torch.cuda.current_device())
    samples = pipeline._upload_samples(
        colors, p, weights=None, seed=seed, lq_max_samples=1 << 18,
        kmeans_niter=niter, kmeans_max_samples=512 ** 2, device=dev)
    centers, valid, _ = pipeline._sample_palette_program(
        *samples, p=p, csp=2, kmeans_niter=niter,
        kmeans_max_samples=512 ** 2, seed=seed, lq_batch_splits=8)
    return centers, valid, samples


class _StrictFusedProgram:
    """Runs the fused sampled program from the sample upload to the first
    pull under ``torch.cuda.set_sync_debug_mode("error")``: any host read
    there raises. Counts the uploads and the first pulls it saw."""

    def __init__(self, torch):
        from patolette_tpu_torch.models import pipeline
        from patolette_tpu_torch.ops import lut

        self.torch, self.pipeline, self.lut = torch, pipeline, lut
        self.uploads = self.pulls = 0

    def _strict(self, fn, on):
        torch = self.torch

        def run(*args, **kw):
            if on:
                torch.cuda.set_sync_debug_mode("error")
                self.uploads += 1
            try:
                return fn(*args, **kw)
            except RuntimeError:  # quantize() reports only the message
                traceback.print_exc(file=sys.stderr)
                torch.cuda.set_sync_debug_mode(0)
                raise
        return run

    def __enter__(self):
        torch, pl, lut = self.torch, self.pipeline, self.lut
        self.real = (pl._upload_samples, pl._sample_lut_program,
                     lut.pull_encoded_v2)
        up, prog, pull = self.real

        def first_pull(*args, **kw):
            torch.cuda.set_sync_debug_mode(0)
            self.pulls += 1
            return pull(*args, **kw)

        pl._upload_samples = self._strict(up, True)
        pl._sample_lut_program = self._strict(prog, False)
        lut.pull_encoded_v2 = first_pull
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        (self.pipeline._upload_samples, self.pipeline._sample_lut_program,
         self.lut.pull_encoded_v2) = self.real


def phase_e2e(torch, profile=False):
    """The undithered main path (K1-K4), float32 and uint8."""
    import numpy as np

    import patolette_tpu_torch as pt

    w, h, p = W, H, 256
    img = synth_image_f32(w, h)
    kw = dict(dither=False, tile_size=0, kmeans_niter=32,
              color_space=pt.ColorSpace_ICtCp)

    def run(colors, **extra):
        ok, pal, pmap, msg = pt.quantize(w, h, colors, p, **kw, **extra)
        check(ok, f"quantize failed: {msg}")
        return pal, pmap

    pal, pmap, stats = _drive(torch, run, img, MAIN_PATH_KERNELS,
                              "the main path")
    used = _check_outputs(pal, pmap, p, w * h)
    mse, mse_cube = _mse_luv(torch, img, pal, pmap)
    check(np.isfinite(mse) and mse < 0.5 * mse_cube,
          f"CIELuv MSE {mse} against {mse_cube} for the 216-colour cube")
    bpp = _check_footprint(stats, w * h, "BYTES_PER_PIXEL")

    # the same pixels as uint8 take the sampled LUT route (K5, no K3); as
    # float32 they take the resident route with the same LQ sample
    img_u8 = np.round(img * 255.0).astype(np.uint8)
    pal8, pmap8, stats8 = _drive(torch, run, img_u8, U8_LUT_KERNELS,
                                 "the uint8 LUT route")
    check(stats8["launches"]["assign_planar"] == 0,
          "K3 launched on the uint8 LUT route")
    check("lut-map-host" in stats8["stage_ms"], "uint8 call missed the route")
    _check_outputs(pal8, pmap8, p, w * h)
    x8 = img_u8.astype(np.float32) / np.float32(255.0)
    mse8, cube8 = _mse_luv(torch, x8, pal8, pmap8)
    check(np.isfinite(mse8) and mse8 < 0.5 * cube8,
          f"uint8 CIELuv MSE {mse8} against {cube8} for the cube")
    palf, pmapf = run(x8)
    mse8f = _mse_luv(torch, x8, palf, pmapf)[0]
    check(abs(mse8 / mse8f - 1.0) <= 0.01,
          f"uint8 LUT route CIELuv MSE {mse8} against {mse8f} as float32")
    # the fused program from the sample upload to the first pull reads
    # nothing back from the device
    with _StrictFusedProgram(torch) as strict:
        pal8s, pmap8s = run(img_u8)
    check(strict.uploads == 1 and strict.pulls == 1,
          f"strict fused call: {strict.uploads} uploads, {strict.pulls} "
          "first pulls")
    check(np.array_equal(pal8s, pal8) and np.array_equal(pmap8s, pmap8),
          "the strict fused call differs")
    # the staged variant (PATOLETTE_NO_FUSED_LUT: the host f64 DP, staged
    # dispatch) on the same call, beside the fused one
    from patolette_tpu_torch import kernels
    from patolette_tpu_torch.models import pipeline

    os.environ["PATOLETTE_NO_FUSED_LUT"] = "1"
    try:
        reset_launches()
        t0 = time.perf_counter()
        pals, pmaps = run(img_u8)
        staged_s = time.perf_counter() - t0
        staged_laps = dict(pipeline.LAST_STAGE_TIMES)
        check("gq-dp" in staged_laps and kernels.LAUNCHES["gq_dp"] == 0,
              "the PATOLETTE_NO_FUSED_LUT call missed the staged variant")
    finally:
        del os.environ["PATOLETTE_NO_FUSED_LUT"]
    _check_outputs(pals, pmaps, p, w * h)
    mse8s = _mse_luv(torch, x8, pals, pmaps)[0]
    check(np.isfinite(mse8s) and mse8s < 0.5 * cube8,
          f"staged uint8 CIELuv MSE {mse8s} against {cube8} for the cube")

    if profile:
        _profile_call(torch, lambda: run(img), "main")
        _profile_call(torch, lambda: run(img_u8), "u8_lut")

    emit({"phase": "e2e", "shape": [w, h], "palette": p, "kmeans_niter": 32,
          **stats, "mp_per_s": w * h / 1e6 / stats["best_s"],
          "peak_device_bytes_per_pixel": bpp,
          "cieluv_mse": mse, "cieluv_mse_cube216": mse_cube,
          "palette_used": used, "bit_identical_runs": True})
    emit({"phase": "e2e-u8-lut", "shape": [w, h], "palette": p,
          "kmeans_niter": 32, **stats8,
          "mp_per_s": w * h / 1e6 / stats8["best_s"],
          "cieluv_mse": mse8, "cieluv_mse_cube216": cube8,
          "cieluv_mse_same_pixels_float32": mse8f,
          "fused_program_sync_debug": "error",
          "staged_wall_s": staged_s, "staged_stage_ms": staged_laps,
          "cieluv_mse_staged": mse8s,
          "mse_ratio_fused_to_staged": mse8 / mse8s,
          "bit_identical_runs": True})
    return (stats["launches"], stats8["launches"],
            stats8["peak_device_bytes"], mse)


def _ramp_u8(w, h):
    """A w x h uint8 grey ramp of 256 levels, every row the same: its
    palette is the 256 greys, whose 2^24 table changes entry more than 32
    times in some 128-block (v2 overflows) and in under MAX_RUNS runs in
    all (v1 holds it)."""
    import numpy as np

    v = (np.arange(w) * 256 // w).astype(np.uint8)
    return np.repeat(np.tile(v, h)[:, None], 3, axis=1)


def phase_e2e_u8_ramp(torch):
    """A 4K uint8 grey ramp on the sampled LUT route: its table overflows
    v2, so pull_lut takes v1 (K6 v1 must launch, as must K5, K6 v2, K1,
    K2, K4 and K10, and K3 must not); the map equals K3's direct map
    against the same palette bit for bit."""
    import numpy as np

    import patolette_tpu_torch as pt
    from patolette_tpu_torch.kernels.colorspace import color_convert
    from patolette_tpu_torch.models import pipeline
    from patolette_tpu_torch.ops import colorspace as cs
    from patolette_tpu_torch.ops.assign import assign_planar

    w, h, p = W, H, 256
    img = _ramp_u8(w, h)
    kw = dict(dither=False, tile_size=0, kmeans_niter=32,
              color_space=pt.ColorSpace_ICtCp)

    def run(colors, **extra):
        ok, pal, pmap, msg = pt.quantize(w, h, colors, p, **kw, **extra)
        check(ok, f"ramp quantize failed: {msg}")
        return pal, pmap

    pal, pmap, stats = _drive(torch, run, img,
                              U8_LUT_KERNELS + ("rle_encode_u8",),
                              "the uint8 ramp")
    check(stats["launches"]["assign_planar"] == 0,
          "K3 launched on the uint8 ramp")
    # the program's v2 words overflowed once; the table went straight to
    # v1, without a second v2 encode
    check(stats["launches"]["rle_encode_u8_v2"] == 1
          and stats["launches"]["rle_encode_u8"] == 1,
          "the ramp's pull: K6 v2 x"
          f"{stats['launches']['rle_encode_u8_v2']}, v1 x"
          f"{stats['launches']['rle_encode_u8']}")
    check("lut-map-host" in stats["stage_ms"], "the ramp missed the route")
    used = _check_outputs(pal, pmap, p, w * h)
    dev = torch.device(DEV, torch.cuda.current_device())
    centers, valid, _ = _program_palette(torch, img, p, 32)
    check(np.array_equal(pipeline._finish_palette(centers, valid, p, 2),
                         pal), "the ramp's palette differs")
    direct = assign_planar(color_convert(pipeline._put(img, dev), 2, "ictcp"),
                           cs.working_to_ictcp(centers, 2),
                           valid).cpu().numpy()
    mismatches = int((direct != pmap).sum())
    check(mismatches == 0,
          f"ramp map differs from K3's direct map on {mismatches} pixels")
    emit({"phase": "e2e-u8-ramp", "shape": [w, h], "palette": p,
          "kmeans_niter": 32, **stats, "palette_used": used,
          "direct_map_mismatches": mismatches, "k6_v2_launches": 1,
          "k6_v1_launches": 1, "bit_identical_runs": True})
    return stats["launches"]


def phase_e2e_image_fused_lut(torch):
    """The opt-in full-image fused LUT route (PATOLETTE_FUSED_IMAGE_LUT=1):
    the 4K uint8 image with saliency, 256 colours, undithered. Its path
    kernels must launch and K3 must not, its peak device bytes must stay
    within the route's footprint model (IMAGE_LUT_BYTES_PER_PIXEL a pixel
    and IMAGE_LUT_FIXED_BYTES), and its map must equal K3's direct map
    against the same palette bit for bit."""
    import numpy as np

    import patolette_tpu_torch as pt
    from patolette_tpu_torch.kernels.colorspace import color_convert
    from patolette_tpu_torch.models import pipeline
    from patolette_tpu_torch.ops import colorspace as cs
    from patolette_tpu_torch.ops.assign import assign_planar

    w, h, p = W, H, 256
    img = np.round(synth_image_f32(w, h) * 255.0).astype(np.uint8)
    kw = dict(dither=False, kmeans_niter=32, color_space=pt.ColorSpace_ICtCp)

    def run(colors, **extra):
        ok, pal, pmap, msg = pt.quantize(w, h, colors, p, **kw, **extra)
        check(ok, f"image fused LUT quantize failed: {msg}")
        return pal, pmap

    seen, real = {}, pipeline._lut_program

    def watched(centers, valid, csp):
        seen.update(centers=centers.clone(), valid=valid.clone())
        return real(centers, valid, csp)

    os.environ["PATOLETTE_FUSED_IMAGE_LUT"] = "1"
    pipeline._lut_program = watched
    try:
        pal, pmap, stats = _drive(torch, run, img, IMAGE_LUT_KERNELS,
                                  "the image fused LUT route")
    finally:
        pipeline._lut_program = real
        del os.environ["PATOLETTE_FUSED_IMAGE_LUT"]
    check(stats["launches"]["assign_planar"] == 0,
          "K3 launched on the image fused LUT route")
    check("saliency+palette+lut-build" in stats["stage_ms"],
          "the call missed the image fused LUT route")
    used = _check_outputs(pal, pmap, p, w * h)
    # the route's model, and what the LQ graphs hold from call to call
    model = pipeline._image_lut_bytes(w * h) + pipeline.LQ_GRAPH_BYTES
    check(stats["peak_device_bytes"] <= model,
          f"peak {stats['peak_device_bytes']} B above the route's model "
          f"{model} B")
    centers, valid = seen["centers"], seen["valid"]
    check(np.array_equal(pipeline._finish_palette(centers, valid, p, 2),
                         pal), "the palette is not the program's")
    dev = torch.device(DEV, torch.cuda.current_device())
    direct = assign_planar(color_convert(pipeline._put(img, dev), 2, "ictcp"),
                           cs.working_to_ictcp(centers, 2),
                           valid).cpu().numpy()
    mismatches = int((direct != pmap).sum())
    check(mismatches == 0, f"image fused LUT map differs from K3's direct "
          f"map on {mismatches} pixels")
    x8 = img.astype(np.float32) / np.float32(255.0)
    mse, cube = _mse_luv(torch, x8, pal, pmap)
    check(np.isfinite(mse) and mse < 0.5 * cube,
          f"image fused LUT CIELuv MSE {mse} against {cube} for the cube")
    fixed = pipeline.IMAGE_LUT_FIXED_BYTES
    emit({"phase": "e2e-image-fused-lut", "shape": [w, h], "palette": p,
          "kmeans_niter": 32, **stats,
          "mp_per_s": w * h / 1e6 / stats["best_s"],
          "peak_device_bytes_per_pixel": stats["peak_device_bytes"] / (w * h),
          "peak_device_bytes_per_pixel_above_fixed":
              (stats["peak_device_bytes"] - fixed) / (w * h),
          "footprint_model_bytes": model, "palette_used": used,
          "cieluv_mse": mse, "cieluv_mse_cube216": cube,
          "direct_map_mismatches": mismatches, "bit_identical_runs": True})
    return stats["launches"]


def phase_e2e_headline(torch, peak_4k):
    """bench.py's headline call through the port: 100 MP uint8, 256
    colours, 25 KMeans iterations, ICtCp, no dither or saliency."""
    import numpy as np

    import patolette_tpu_torch as pt
    from patolette_tpu_torch import kernels
    from patolette_tpu_torch.models import pipeline

    w, h, p, iters = HEADLINE_W, HEADLINE_H, 256, 25
    t0 = time.perf_counter()
    img = synth_image_u8(w, h)
    synth_s = time.perf_counter() - t0

    def run():
        ok, pal, pmap, msg = pt.quantize(
            w, h, img, p, dither=False, tile_size=0, kmeans_niter=iters,
            color_space=pt.ColorSpace_ICtCp)
        check(ok, f"headline quantize failed: {msg}")
        return pal, pmap

    t0 = time.perf_counter()
    run()
    warm_s = time.perf_counter() - t0
    walls, laps = [], []
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pal, pmap = None, None
    for i in range(3):
        t0 = time.perf_counter()
        pal2, pmap2 = run()
        walls.append(time.perf_counter() - t0)
        laps.append(dict(pipeline.LAST_STAGE_TIMES))
        if i == 0:
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            for name in U8_LUT_KERNELS:
                check(launches[name] > 0,
                      f"kernel {name} not launched on the headline call")
            check(launches["assign_planar"] == 0, "K3 launched (headline)")
            pal, pmap = pal2, pmap2
        else:
            check(np.array_equal(pal, pal2) and np.array_equal(pmap, pmap2),
                  "two headline calls differ")
    _check_outputs(pal, pmap, p, w * h)
    idx = np.random.default_rng(1).integers(0, w * h, size=1 << 20)
    sub = img[idx].astype(np.float32) / np.float32(255.0)
    mse, cube = _mse_luv(torch, sub, pal, pmap[idx])
    check(np.isfinite(mse) and mse < 0.5 * cube,
          f"headline CIELuv MSE {mse} against {cube} for the cube")
    check(abs(peak - peak_4k) <= 0.1 * peak_4k,
          f"headline peak device bytes {peak} against {peak_4k} at 4K")
    # the fused program's palette is palette_pipeline_device's on the same
    # samples: at p = 256 the KMeans cap is the LQ sample's size, so KMeans
    # runs on the LQ sample (S11) and the core draws nothing
    centers, valid, samples = _program_palette(torch, img, p, iters)
    check(samples[2] is None, "no S11 reuse at the headline shape")
    ref = pipeline.palette_pipeline_device(
        samples[0], None, p, color_space=2, kmeans_niter=iters,
        kmeans_max_samples=512 ** 2, seed=1234, lq_max_samples=0,
        with_map=False)
    check(torch.equal(centers, ref[0]) and torch.equal(valid, ref[1]),
          "the fused program's palette differs from "
          "palette_pipeline_device's on the same samples")
    check(np.array_equal(pipeline._finish_palette(centers, valid, p, 2),
                         pal), "the headline palette is not the program's")
    del samples, ref
    torch.cuda.reset_peak_memory_stats()
    with _K5Watch() as k5_seen:
        ok, *_ = pt.quantize(w, h, img, p, dither=False, tile_size=0,
                             kmeans_niter=iters,
                             color_space=pt.ColorSpace_ICtCp,
                             sync_stages=True)
    check(ok, "synced headline call failed")
    synced = dict(pipeline.LAST_STAGE_TIMES)
    best = min(walls)
    emit({"phase": "e2e-headline", "shape": [w, h], "palette": p,
          "kmeans_niter": iters, "synth_s": synth_s, "warmup_s": warm_s,
          "wall_s": walls, "best_s": best, "mp_per_s": w * h / 1e6 / best,
          "stage_ms": laps[walls.index(best)], "stage_ms_synced": synced,
          "launches": launches, "peak_device_bytes": peak,
          "peak_device_bytes_4k_u8": peak_4k, "cieluv_mse_1m": mse,
          "palette_equals_palette_pipeline_device": True,
          "cieluv_mse_cube216_1m": cube, "bit_identical_runs": True})

    # 1024 colours on the same image: above 256 entries the table is u16,
    # and at 100 MP (over _lut_min_pixels(1024) = 2^25) the call keeps the
    # sampled route, so this path launches K5's u16 instantiation
    p16 = 1024
    reset_launches()
    t0 = time.perf_counter()
    with _K5Watch(k5_seen):
        ok, pal16, pmap16, msg = pt.quantize(
            w, h, img, p16, dither=False, tile_size=0, kmeans_niter=iters,
            color_space=pt.ColorSpace_ICtCp)
    wall16 = time.perf_counter() - t0
    check(ok, f"1024-colour headline quantize failed: {msg}")
    launches16 = dict(kernels.LAUNCHES)
    check(launches16["lut_argmin"] > 0 and launches16["assign_planar"] == 0,
          "the 1024-colour call missed the sampled LUT route")
    check(launches16["rle_encode_u16_v2"] > 0
          and launches16["rle_encode_u8_v2"] == 0,
          "the 1024-colour call did not pull its table through u16 v2")
    laps16 = dict(pipeline.LAST_STAGE_TIMES)
    check("lut-map-host" in laps16, "the 1024-colour call missed the route")
    _check_outputs(pal16, pmap16, p16, w * h)
    mse16 = _mse_luv(torch, sub, pal16, pmap16[idx])[0]
    check(np.isfinite(mse16) and mse16 < mse,
          f"1024-colour CIELuv MSE {mse16} against {mse} with 256")
    emit({"phase": "e2e-headline-u16", "shape": [w, h], "palette": p16,
          "kmeans_niter": iters, "wall_s": wall16, "stage_ms": laps16,
          "launches": launches16, "cieluv_mse_1m": mse16})
    kernel_k5_headline(torch, k5_seen)
    return img, launches16, mse


class _K5Watch:
    """Record the palette each K5 table build of the pipeline gets (by
    output type) into ``seen``."""

    def __init__(self, seen=None):
        from patolette_tpu_torch.ops import lut

        self.lut, self.real = lut, lut.lut_argmin
        self.seen = {} if seen is None else seen

    def __enter__(self):
        def watched(grid, centers, valid, out_dtype):
            self.seen[out_dtype] = (centers.clone(), valid.clone())
            return self.real(grid, centers, valid, out_dtype)

        self.lut.lut_argmin = watched
        return self.seen

    def __exit__(self, *exc):
        self.lut.lut_argmin = self.real


def kernel_k5_headline(torch, seen):
    """K5 on the headline calls' own palettes (256 colours, u8; 1024, u16)
    on the cached grid: equal to its plain version and to K3 on all 2^24
    codes, with the centres each warp scanned."""
    from patolette_tpu_torch.ops import lut

    check(set(seen) == {torch.uint8, torch.uint16},
          f"the headline calls built tables of {sorted(map(str, seen))}")
    grid = lut.grid_ictcp(2, DEV)
    out = {}
    for dtype, (centers, valid) in seen.items():
        _, cand, _ = _k5_hold(torch, grid, centers, valid, dtype,
                              f"headline {dtype}")
        out[str(dtype)] = dict(entries=centers.shape[0],
                               valid=int(valid.sum()), candidates=cand)
    emit({"phase": "kernel-k5-headline", "palettes": out, "identical": True})


def phase_routes(torch, img_100mp):
    """One-off measurement: the sampled LUT route against the resident
    route (K3 direct map) at 4, 8.3 and 33 MP uint8, called directly, in
    turns; then the host map at 100 MP against plain torch CPU ops and
    against a gather on the card."""
    import numpy as np

    from patolette_tpu_torch.models import pipeline as TP
    from patolette_tpu_torch.ops import lut

    dev = torch.device(DEV, torch.cuda.current_device())
    kw = dict(palette_only=False, csp=2, kmeans_niter=25,
              kmeans_max_samples=512 ** 2, verbose=False, weights=None,
              lq_max_samples=1 << 18, lq_batch_splits=8, seed=1234,
              device=dev)

    def best(fn, reps=3):
        fn()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t0)
        return min(walls), walls

    for w, h in ROUTE_SHAPES:
        img = synth_image_u8(w, h)
        routes = {
            "sampled_lut": lambda: TP._quantize_via_samples(
                img, 256, timer=TP._StageTimer(False, False, dev), **kw),
            "resident_direct": lambda: TP._quantize_resident(
                img, 256, width=w, height=h, dither=False,
                dither_segment=4096,
                tile_size=0.0, timer=TP._StageTimer(False, False, dev),
                **kw),
        }
        for fn in routes.values():
            fn()
        walls = {name: [] for name in routes}
        laps = {name: [] for name in routes}
        # in turns, so that a drift of the host's speed hits both alike
        for name in ("sampled_lut", "resident_direct") * 2 + (
                "resident_direct", "sampled_lut") * 2:
            t0 = time.perf_counter()
            routes[name]()
            walls[name].append(time.perf_counter() - t0)
            laps[name].append(dict(TP.LAST_STAGE_TIMES))
        out = {"phase": "routes", "shape": [w, h]}
        for name in routes:
            out[name + "_wall_s"] = walls[name]
            out[name + "_median_s"] = statistics.median(walls[name])
            out[name + "_stage_ms"] = laps[name][
                walls[name].index(min(walls[name]))]
        emit(out)
        del img, routes

    img = img_100mp
    n = img.shape[0]
    table = torch.randint(0, 256, (lut.LUT_SIZE,), dtype=torch.uint8)
    want = lut.lut_map_host(img, table)

    def torch_cpu():
        x = torch.from_numpy(img)
        codes = x[:, 0].to(torch.int32).mul_(256).add_(x[:, 1]).mul_(
            256).add_(x[:, 2])
        return torch.index_select(table.to(torch.int32), 0, codes).numpy()

    table_dev = table.to(DEV)

    def device_gather():
        x = torch.from_numpy(img).to(DEV)
        codes = x[:, 0].to(torch.int32).mul_(256).add_(x[:, 1]).mul_(
            256).add_(x[:, 2])
        return table_dev[codes.long()].to(torch.int32).cpu().numpy()

    check(np.array_equal(torch_cpu(), want), "torch CPU map differs")
    check(np.array_equal(device_gather(), want), "device gather differs")
    emit({"phase": "routes-host-map", "pixels": n,
          "lut_map_host_s": best(lambda: lut.lut_map_host(img, table)),
          "torch_cpu_ops_s": best(torch_cpu),
          "device_gather_s": best(device_gather),
          "host_threads": os.cpu_count()})


def _block_mse_luv(torch, colors, pal, pmap, w, h, block=8):
    """CIELuv MSE between the 8x8 block means of the image and of
    ``pal[pmap]``: what an eye sees from a distance, and what dithering
    buys over the nearest colour."""
    from patolette_tpu_torch.ops import colorspace as cs

    x = torch.from_numpy(colors.astype("float32")).to(DEV)
    pl = torch.from_numpy(pal.astype("float32")).to(DEV)
    idx = torch.from_numpy(pmap.astype("int64")).to(DEV)

    def means(v):
        luv = cs.srgb_to_working(v, 1).reshape(h // block, block,
                                               w // block, block, 3)
        return luv.mean(dim=(1, 3))

    return float(((means(x) - means(pl[idx])) ** 2).sum(-1).mean())


def _direct_map(torch, colors, pal):
    """Nearest palette entry in ICtCp (K3) for the same palette."""
    from patolette_tpu_torch.ops import colorspace as cs
    from patolette_tpu_torch.ops.assign import assign_planar

    x = torch.from_numpy(colors.astype("float32")).to(DEV)
    used = torch.from_numpy(pal[:, 0] >= 0).to(DEV)
    pl = torch.from_numpy(pal.astype("float32")).to(DEV).clamp(0.0, 1.0)
    xi = cs.srgb_to_working(tuple(x[:, k] for k in range(3)), 2)
    return assign_planar(xi, cs.srgb_to_working(pl, 2), used).cpu().numpy()


def _cube_dithered_mse(torch, colors, w, h):
    """CIELuv MSE of the image dithered (ICtCp, default segment) against
    the 216-colour uniform sRGB cube: the yardstick of a dithered map,
    whose per-pixel error is by design several times the nearest
    colour's."""
    import numpy as np

    from patolette_tpu_torch.models import dither
    from patolette_tpu_torch.ops import colorspace as cs

    g = np.arange(6, dtype=np.float32) / np.float32(5.0)
    cube = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    x = torch.from_numpy(colors.astype("float32")).to(DEV)
    xw = cs.srgb_to_working(tuple(x[:, k] for k in range(3)), 2)
    cw = cs.srgb_to_working(torch.from_numpy(cube).to(DEV), 2)
    cmap = dither.riemersma_dither_planar(
        xw, cw, torch.ones(216, dtype=torch.bool, device=DEV), w, h, 2)
    return _mse_luv(torch, colors, cube, cmap.cpu().numpy())[0]


def phase_e2e_default(torch, profile=False):
    """The library's default call (saliency, dither), float32 and uint8."""
    import numpy as np

    import patolette_tpu_torch as pt
    from patolette_tpu_torch import kernels

    from patolette_tpu_torch.ops import lut

    w, h, p = W, H, 256
    img = synth_image_f32(w, h)
    lut.clear_grid_cache()  # the uint8 route's grid is not this call's

    def run(colors, **extra):
        ok, pal, pmap, msg = pt.quantize(w, h, colors, p, **extra)
        check(ok, f"default quantize failed: {msg}")
        return pal, pmap

    pal, pmap, stats = _drive(torch, run, img, DEFAULT_PATH_KERNELS,
                              "the default call")
    used = _check_outputs(pal, pmap, p, w * h)
    bpp = _check_footprint(stats, w * h, "BYTES_PER_PIXEL_SALIENCY_OR_DITHER")
    mse_cube = _mse_luv(torch, img, pal, pmap)[1]
    quality = _dither_quality(torch, img, pal, pmap, w, h, "default call")

    img_u8 = np.round(img * 255.0).astype(np.uint8)
    reset_launches()
    t0 = time.perf_counter()
    pal8, pmap8 = run(img_u8)
    u8_s = time.perf_counter() - t0
    launches8 = dict(kernels.LAUNCHES)
    for name in DEFAULT_PATH_KERNELS:
        check(launches8[name] > 0, f"kernel {name} not launched (uint8)")
    pal8b, pmap8b = run(img_u8)
    check(np.array_equal(pal8, pal8b) and np.array_equal(pmap8, pmap8b),
          "two uint8 default calls differ")
    x8 = img_u8.astype(np.float32) / 255.0
    quality8 = _dither_quality(torch, x8, pal8, pmap8, w, h,
                               "uint8 default call")

    if profile:
        _profile_call(torch, lambda: run(img), "default")

    emit({"phase": "e2e-default", "shape": [w, h], "palette": p,
          "kmeans_niter": 32, "dither_segment": 4096, "tile_size": 512.0,
          **stats, "mp_per_s": w * h / 1e6 / stats["best_s"],
          "peak_device_bytes_per_pixel": bpp,
          "cieluv_mse_cube216": mse_cube, **quality, "palette_used": used,
          "uint8_wall_s": u8_s, "uint8_launches": launches8,
          **{"uint8_" + k: v for k, v in quality8.items()},
          "bit_identical_runs": True})
    return stats["launches"]


ONE_SHOT_PATH_KERNELS = ("gq_dp", "segment_sum", "lq_candidates",
                         "kmeans_step", "color_convert", "assign_planar")
ONE_SHOT_DEFAULT_KERNELS = ("gq_dp", "segment_sum", "lq_candidates",
                            "kmeans_step", "color_convert", "mbd",
                            "visit_order", "dither_scan")
# the one-shot call's CIELuv MSE against the resident route's on the same
# call (their draws differ: torch.Generator on the card, numpy on the host)
ONE_SHOT_MSE_RATIO = 1.02


class _StrictPaletteCore:
    """Runs ``pipeline._palette_core`` under
    ``torch.cuda.set_sync_debug_mode("error")``: any host read inside it
    raises. Counts the calls."""

    def __init__(self, torch):
        from patolette_tpu_torch.models import pipeline

        self.torch, self.pipeline = torch, pipeline
        self.calls = 0

    def __enter__(self):
        torch, orig = self.torch, self.pipeline._palette_core

        def strict(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(*args, **kw)
            except RuntimeError:  # quantize() reports only the message
                traceback.print_exc(file=sys.stderr)
                raise
            finally:
                torch.cuda.set_sync_debug_mode(0)
                self.calls += 1

        self.orig = orig
        self.pipeline._palette_core = strict
        return self

    def __exit__(self, *exc):
        self.pipeline._palette_core = self.orig


def _host_syncs(torch, call):
    """Synchronizing CUDA operations of one call (the sync debug mode's
    warnings: the upload, the read back and whatever else waits)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_e2e_one_shot(torch, profile=False):
    """The one-shot route at its largest size, 2048x2048 (exactly 2^22
    pixels), 256 colours, ICtCp: undithered with 32 KMeans iterations, and
    the library's default call. Each call's path kernels must launch (K11
    among them), its palette core must run with no host read (sync debug
    mode "error"), two runs must agree bit for bit, its peak device bytes
    a pixel must stay within the route's footprint model (the pipeline's
    ONE_SHOT_BYTES_PER_PIXEL*), and its CIELuv MSE must be within
    ONE_SHOT_MSE_RATIO of the resident route's
    (PATOLETTE_NO_ONE_SHOT) on the same call; the default call also passes
    the dither checks."""
    import numpy as np

    import patolette_tpu_torch as pt

    w, h, p = ONE_SHOT_W, ONE_SHOT_H, 256
    img = synth_image_f32(w, h)
    calls = (("e2e-one-shot", dict(dither=False, tile_size=0,
                                   kmeans_niter=32,
                                   color_space=pt.ColorSpace_ICtCp),
              ONE_SHOT_PATH_KERNELS),
             ("e2e-one-shot-default", {}, ONE_SHOT_DEFAULT_KERNELS))
    launches = {}
    for name, kw, path in calls:
        def run(colors, **extra):
            ok, pal, pmap, msg = pt.quantize(w, h, colors, p, **kw, **extra)
            check(ok, f"{name} failed: {msg}")
            return pal, pmap

        with _StrictPaletteCore(torch) as strict:
            pal, pmap, stats = _drive(torch, run, img, path, name)
        check(strict.calls >= 5, f"{name}: palette core not reached")
        check("one-shot" in stats["stage_ms"], f"{name} missed the route")
        used = _check_outputs(pal, pmap, p, w * h)
        # the footprint model the device-budget guard holds this route to
        _check_footprint(stats, w * h, "ONE_SHOT_BYTES_PER_PIXEL" if name
                         == "e2e-one-shot" else
                         "ONE_SHOT_BYTES_PER_PIXEL_SALIENCY_OR_DITHER")
        syncs = _host_syncs(torch, lambda: run(img))
        os.environ["PATOLETTE_NO_ONE_SHOT"] = "1"
        try:
            t0 = time.perf_counter()
            rpal, rmap = run(img)
            resident_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rpal, rmap = run(img)
            resident_s = min(resident_s, time.perf_counter() - t0)
            from patolette_tpu_torch.models import pipeline

            check("lq" in pipeline.LAST_STAGE_TIMES,
                  f"{name}: the resident call missed its route")
        finally:
            del os.environ["PATOLETTE_NO_ONE_SHOT"]
        mse = _mse_luv(torch, img, pal, pmap)[0]
        mse_res = _mse_luv(torch, img, rpal, rmap)[0]
        check(np.isfinite(mse) and mse <= ONE_SHOT_MSE_RATIO * mse_res,
              f"{name}: CIELuv MSE {mse} against the resident route's "
              f"{mse_res}")
        extra = {}
        if kw.get("dither", True):
            extra = _dither_quality(torch, img, pal, pmap, w, h, name)
        if profile:
            _profile_call(torch, lambda: run(img), name)
        emit({"phase": name, "shape": [w, h], "palette": p,
              "kmeans_niter": 32, **stats,
              "mp_per_s": w * h / 1e6 / stats["best_s"],
              "peak_device_bytes_per_pixel":
                  stats["peak_device_bytes"] / (w * h),
              "palette_core_sync_debug": "error",
              "palette_core_calls": strict.calls,
              "host_syncs_whole_call": syncs,
              "cieluv_mse": mse, "cieluv_mse_resident": mse_res,
              "mse_ratio_to_resident": mse / mse_res,
              "resident_best_s": resident_s, "palette_used": used,
              **extra, "bit_identical_runs": True})
        launches[name] = stats["launches"]
    return launches["e2e-one-shot"], launches["e2e-one-shot-default"]


API_PCA_N = 1 << 20
API_PCA_ATOL = 1e-6
# test_torch_colorspace.py's tolerance for sRGB-valued outputs
API_SRGB_ATOL = 1e-4


def pca_covariances(n, seed=0):
    """``n`` symmetric 3x3 f32 covariances, a degenerate one in every 64
    (zero, a multiple of the identity, a distinct diagonal, rank one, below
    ``pca_from_cov``'s delta). The others have their top eigenvalue apart
    (0.7-1 of the scale against 0.25-0.45 and 0-0.2) and its eigenvector
    in the positive octant, so every column pca_from_cov may pick points
    the same way: the card's libm and the CPU's may break a near-tie of
    two column norms differently, which would flip an axis of mixed
    signs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q = np.abs(rng.standard_normal((n, 3)))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = q.copy()
    v[:, 2] -= 1.0                          # Householder: e3 -> q
    vv = np.maximum((v * v).sum(1), 1e-30)[:, None, None]
    rot = np.eye(3) - 2.0 * v[:, :, None] * v[:, None, :] / vv
    lam = np.stack([rng.uniform(0.0, 0.2, n), rng.uniform(0.25, 0.45, n),
                    rng.uniform(0.7, 1.0, n)], -1)
    lam *= 10.0 ** rng.uniform(-3, 3, (n, 1))
    cov = np.einsum("nij,nj,nkj->nik", rot, lam, rot)
    u = np.array([0.2, 0.5, 0.8])
    degenerate = np.stack([np.zeros((3, 3)), 2.5 * np.eye(3),
                           np.diag([0.1, 3.0, 0.7]), np.outer(u, u),
                           1e-18 * np.eye(3)])
    cov[::64] = degenerate[np.arange(len(cov[::64])) % len(degenerate)]
    return cov.astype(np.float32)


def phase_api(torch):
    """The JAX package's last public functions on the card at the default
    call's width (3840x2160), each against the port function it is built
    on: get_weights against get_weights_planar of the same channels and
    mbd against K9's wrapper (bit for bit, K9 and K10 launched);
    riemersma_dither on (N, 3) working rows against riemersma_dither_planar
    of the same planes (bit for bit; K10 for the image and for the palette,
    K7 and K8 once each); cieluv_to_srgb and ictcp_to_srgb of K10's working
    image against the same glue on the CPU, and back to the input; and
    pca_from_cov on API_PCA_N covariances against device="cpu". One line
    a check, with its wall time."""
    import numpy as np

    from patolette_tpu_torch import kernels
    from patolette_tpu_torch.kernels import mbd as K9
    from patolette_tpu_torch.kernels.colorspace import color_convert
    from patolette_tpu_torch.models import dither, saliency
    from patolette_tpu_torch.ops import colorspace as cs
    from patolette_tpu_torch.ops import eigen3

    w, h = W, H
    img = synth_image_f32(w, h)
    x = torch.from_numpy(img).to(DEV)
    planes = tuple(x[:, k].contiguous() for k in range(3))

    def timed(name, fn, **found):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        line = {"phase": "api-" + name, "shape": [w, h],
                "wall_s": time.perf_counter() - t0,
                "launches": {k: v for k, v in kernels.LAUNCHES.items() if v}}
        for kname, count in found.items():
            check(kernels.LAUNCHES[kname] == count,
                  f"api {name}: {kname} launched "
                  f"{kernels.LAUNCHES[kname]} times, not {count}")
        return result, line

    got, line = timed("get_weights", lambda: saliency.get_weights(
        x.view(h, w, 3), 512.0), mbd=1)
    check(kernels.LAUNCHES["color_convert"] > 0, "api get_weights: no K10")
    want = saliency.get_weights_planar(planes, h, w, 512.0)
    check(got.shape == (w * h,) and torch.equal(got, want),
          "get_weights differs from get_weights_planar")
    emit({**line, "equals_get_weights_planar": True})

    grey = ((planes[0] + planes[1] + planes[2]) / 3.0).view(h, w)
    got, line = timed("mbd", lambda: saliency.mbd(grey), mbd=1)
    check(torch.equal(got, K9.mbd(grey)), "mbd differs from K9's wrapper")
    emit({**line, "equals_k9": True})

    xw = torch.stack(color_convert(x, 2, "working"), 1)
    pal = xw[torch.randint(0, w * h, (256,), device=DEV,
                           generator=torch.Generator(DEV).manual_seed(3))]
    valid = torch.arange(256, device=DEV) != 7
    got, line = timed("riemersma_dither", lambda: dither.riemersma_dither(
        xw, pal, valid, w, h, 2), color_convert=2, visit_order=1,
        dither_scan=1)
    want = dither.riemersma_dither_planar(
        tuple(xw[:, k].contiguous() for k in range(3)), pal, valid, w, h, 2)
    check(torch.equal(got, want),
          "riemersma_dither differs from riemersma_dither_planar")
    check(not (got == 7).any(), "riemersma_dither chose an invalid entry")
    emit({**line, "equals_riemersma_dither_planar": True})

    sub = slice(0, None, 8)  # the CPU's share: every 8th pixel
    for name, csp in (("cieluv_to_srgb", 1), ("ictcp_to_srgb", 2)):
        work = color_convert(x, csp, "working")
        got, line = timed(name, lambda: getattr(cs, name)(work))
        cpu = getattr(cs, name)(tuple(c[sub].cpu() for c in work))
        dev_err = max(float((g[sub].cpu() - c).abs().max())
                      for g, c in zip(got, cpu))
        back = max(float((g - x[:, k]).abs().max())
                   for k, g in enumerate(got))
        back_cpu = max(float((c - x[sub, k].cpu()).abs().max())
                       for k, c in enumerate(cpu))
        check(dev_err <= API_SRGB_ATOL, f"{name}: card against CPU {dev_err}")
        # CIELuv comes back within the sRGB tolerance; ICtCp in f32 loses
        # the darkest colours' last bits through the PQ curve (~2e-3 on the
        # CPU too), so its way back is held to the CPU's own
        check(back <= (API_SRGB_ATOL if csp == 1 else
                       back_cpu + API_SRGB_ATOL),
              f"{name}: back to the input within {back}")
        emit({**line, "max_abs_err_to_cpu": dev_err,
              "max_abs_err_to_input": back,
              "max_abs_err_to_input_cpu_every_8th": back_cpu})

    cov = pca_covariances(API_PCA_N)
    cov_dev = torch.from_numpy(cov).to(DEV)
    (axis, expl), line = timed("pca_from_cov",
                               lambda: eigen3.pca_from_cov(cov_dev))
    axis_c, expl_c = eigen3.pca_from_cov(cov, device="cpu")
    err = max(float((axis.cpu() - axis_c).abs().max()),
              float((expl.cpu() - expl_c).abs().max()))
    check(np.isfinite(err) and err <= API_PCA_ATOL,
          f"pca_from_cov: card against CPU {err}")
    emit({**line, "n": API_PCA_N, "max_abs_err_to_cpu": err,
          "atol": API_PCA_ATOL})


def _dither_quality(torch, colors, pal, pmap, w, h, what):
    """The checks of a dithered map: its per-pixel CIELuv MSE under half
    the 216-colour cube's dithered the same way, and its 8x8 block means
    no worse than the undithered map's with the same palette."""
    import numpy as np

    mse = _mse_luv(torch, colors, pal, pmap)[0]
    cube = _cube_dithered_mse(torch, colors, w, h)
    check(np.isfinite(mse) and mse < 0.5 * cube,
          f"{what}: dithered CIELuv MSE {mse} against {cube} for the "
          "dithered cube")
    direct = _direct_map(torch, colors, pal)
    block = _block_mse_luv(torch, colors, pal, pmap, w, h)
    block_direct = _block_mse_luv(torch, colors, pal, direct, w, h)
    check(block <= block_direct,
          f"{what}: 8x8 block-mean CIELuv error {block} of the dither "
          f"against {block_direct} for the undithered map")
    return {"cieluv_mse": mse, "cieluv_mse_cube216_dithered": cube,
            "cieluv_mse_undithered": _mse_luv(torch, colors, pal, direct)[0],
            "block8_cieluv_mse": block,
            "block8_cieluv_mse_undithered": block_direct}


def _strip_count(w, h):
    from patolette_tpu_torch.models import pipeline

    rows = max(1, pipeline._stream_strip_pixels(w * h) // w)
    return -(-h // rows), rows


def _check_streamed(stats, what, absent):
    """The call took the streamed route and launched none of ``absent``."""
    check("strip-in" in stats["stage_ms"], f"{what} missed the streamed "
          "route")
    for name in absent:
        check(stats["launches"][name] == 0, f"{name} launched on {what}")


def phase_e2e_strip_dither(torch, profile=False):
    """A dithered call without saliency above 4 MP streams per row strip:
    the 4K float32 image, 256 colours, 32 iterations, on 2 strips through
    the planar feed (each strip its own curve, a fresh queue at the
    seam)."""
    import patolette_tpu_torch as pt
    from patolette_tpu_torch.ops import lut

    w, h, p = W, H, 256
    img = synth_image_f32(w, h)
    lut.clear_grid_cache()  # the LUT route's grid is not this call's

    def run(colors, **extra):
        ok, pal, pmap, msg = pt.quantize(w, h, colors, p, dither=True,
                                         tile_size=0, kmeans_niter=32,
                                         **extra)
        check(ok, f"strip dither quantize failed: {msg}")
        return pal, pmap

    pal, pmap, stats = _drive(torch, run, img, STRIP_DITHER_KERNELS,
                              "the strip dither")
    strips, rows = _strip_count(w, h)
    _check_streamed(stats, "the strip dither", ("assign_planar", "mbd"))
    check(strips == 2, f"{strips} strips at 4K")
    used = _check_outputs(pal, pmap, p, w * h)
    quality = _dither_quality(torch, img, pal, pmap, w, h, "strip dither")
    if profile:
        _profile_call(torch, lambda: run(img), "strip_dither")
    emit({"phase": "e2e-strip-dither", "shape": [w, h], "palette": p,
          "kmeans_niter": 32, "strips": strips, "strip_rows": rows, **stats,
          "mp_per_s": w * h / 1e6 / stats["best_s"],
          "peak_device_bytes_per_pixel": stats["peak_device_bytes"] / (w * h),
          **quality, "palette_used": used, "bit_identical_runs": True})
    return stats["launches"]


def phase_e2e_strip_headline(torch, img_100mp):
    """bench.py's 100 MP uint8 image dithered without saliency: the packed
    uint8 feed on 6 strips of 1677 rows; then a 7680x4320 uint8 image, 2
    strips of about the same size. With one strip on the device at a time,
    the 100 MP call's peak device memory stays within 10% of the 33 MP
    call's."""
    import numpy as np

    import patolette_tpu_torch as pt

    p, iters = 256, 25
    out = {}
    for w, h, img in ((HEADLINE_W, HEADLINE_H, img_100mp),
                      (STRIP_33MP_W, STRIP_33MP_H, None)):
        if img is None:
            img = synth_image_u8(w, h)

        def run(colors, **extra):
            ok, pal, pmap, msg = pt.quantize(w, h, colors, p, dither=True,
                                             tile_size=0, kmeans_niter=iters,
                                             **extra)
            check(ok, f"{w}x{h} strip dither failed: {msg}")
            return pal, pmap

        what = f"the {w}x{h} uint8 strip dither"
        pal, pmap, stats = _drive(torch, run, img, STRIP_DITHER_KERNELS,
                                  what)
        strips, rows = _strip_count(w, h)
        _check_streamed(stats, what, ("assign_planar", "mbd"))
        _check_outputs(pal, pmap, p, w * h)
        check(np.isfinite(pal).all(), f"{what}: palette not finite")
        out[(w, h)] = dict(shape=[w, h], strips=strips, strip_rows=rows,
                           mp_per_s=w * h / 1e6 / stats["best_s"], **stats)
        del img
    big = out[(HEADLINE_W, HEADLINE_H)]
    small = out[(STRIP_33MP_W, STRIP_33MP_H)]
    check(big["strips"] == 6 and small["strips"] == 2, "strip counts")
    ratio = big["peak_device_bytes"] / small["peak_device_bytes"]
    check(ratio <= 1.1, f"100 MP peak device memory {ratio}x the 33 MP "
          "call's")
    emit({"phase": "e2e-strip-headline", "palette": p, "kmeans_niter": iters,
          **big, "peak_ratio_to_33mp": ratio, "at_33mp": small,
          "bit_identical_runs": True})
    return big["launches"]


def phase_e2e_over_budget(torch, mse_resident):
    """The 4K float32 undithered call pushed onto the streamed route by a
    device budget lowered for this call alone: its map equals K3's
    whole-image map against the same palette bit for bit (the nearest
    entry decomposes exactly over strips), and its CIELuv MSE is within 1%
    of the resident call's."""
    import numpy as np

    import patolette_tpu_torch as pt
    from patolette_tpu_torch.kernels.colorspace import color_convert
    from patolette_tpu_torch.models import pipeline
    from patolette_tpu_torch.ops import colorspace as cs
    from patolette_tpu_torch.ops.assign import assign_planar

    w, h, p = W, H, 256
    img = synth_image_f32(w, h)
    kw = dict(dither=False, tile_size=0, kmeans_niter=32,
              color_space=pt.ColorSpace_ICtCp)

    def run(colors, **extra):
        ok, pal, pmap, msg = pt.quantize(w, h, colors, p, **kw, **extra)
        check(ok, f"over-budget quantize failed: {msg}")
        return pal, pmap

    saved = pipeline.DEVICE_BUDGET_FRACTION
    pipeline.DEVICE_BUDGET_FRACTION = 1e-4  # ~8 MB: far under this call
    try:
        pal, pmap, stats = _drive(torch, run, img, OVER_BUDGET_KERNELS,
                                  "the over-budget call")
    finally:
        pipeline.DEVICE_BUDGET_FRACTION = saved
    strips, rows = _strip_count(w, h)
    _check_streamed(stats, "the over-budget call",
                    ("visit_order", "dither_scan", "mbd"))
    _check_outputs(pal, pmap, p, w * h)

    # the streamed route's palette, then K3 over the whole image
    dev = torch.device(DEV, torch.cuda.current_device())
    centers, valid, _ = _program_palette(torch, img, p, 32)
    check(np.array_equal(pipeline._finish_palette(centers, valid, p, 2),
                         pal), "the over-budget call's palette differs")
    xw = color_convert(pipeline._put(img, dev), 2, "working")
    whole = assign_planar(cs.working_to_ictcp(xw, 2),
                          cs.working_to_ictcp(centers, 2),
                          valid).cpu().numpy()
    mismatches = int((whole != pmap).sum())
    check(mismatches == 0, f"streamed map differs from K3's whole-image map "
          f"on {mismatches} pixels")
    mse = _mse_luv(torch, img, pal, pmap)[0]
    check(abs(mse / mse_resident - 1.0) <= 0.01,
          f"over-budget CIELuv MSE {mse} against {mse_resident} resident")
    emit({"phase": "e2e-over-budget", "shape": [w, h], "palette": p,
          "kmeans_niter": 32, "strips": strips, "strip_rows": rows, **stats,
          "mp_per_s": w * h / 1e6 / stats["best_s"],
          "whole_image_k3_mismatches": mismatches, "cieluv_mse": mse,
          "cieluv_mse_resident": mse_resident, "bit_identical_runs": True})
    return stats["launches"]


MESH_U8_KERNELS = ("color_convert", "lut_argmin", "rle_encode_u8_v2",
                   "gq_dp", "segment_sum", "lq_candidates", "kmeans_step")
MESH_F32_KERNELS = ("color_convert", "assign_planar", "gq_dp",
                    "segment_sum", "lq_candidates", "kmeans_step")
MESH_DEFAULT_KERNELS = DEFAULT_PATH_KERNELS + ("gq_dp",)
MESH_LAPS = {"stage-in", "palette (sharded)", "nn-map"}
MESH_DEFAULT_LAPS = {"stage-in", "saliency", "palette (sharded)", "dither"}
# The mesh route draws its samples per rank from (seed, rank), the
# single-device route from seed: two draws of the same size, whose CIELuv
# MSEs may differ by a draw's spread (not a parity check).
MESH_MSE_RATIO = 1.02
# Four strips change the default call by design (the JAX package's
# semantics): strip-local saliency borders move the weights, and each
# strip is dithered along its own curve with a fresh queue. Its dithered
# map is held to the absolute dither checks, and its per-pixel MSE only
# bounded against world 1's, at each seed of MESH4_SEEDS (a coarse guard:
# the per-strip semantics are held against the JAX package's
# dither_sharded and saliency_sharded by the CPU tests). The readings it
# was set from are in PERF.md.
MESH4_DEFAULT_RATIO = 1.10
MESH4_SEEDS = (1234, 1, 2)
# quantize_palette_distributed on four ranks against one: each rank draws
# its share of the samples from (seed, rank) (README T5's bound)
MESH4_PALETTE_RATIO = 1.01


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _TableWatch:
    """Record the palette each sharded table build gets and the table the
    ranks assemble (the pipeline calls both through ``ops.lut``)."""

    def __init__(self):
        from patolette_tpu_torch.ops import lut

        self.lut = lut
        self.real = (lut.build_lut_enc_sharded, lut.pull_lut_sharded)
        self.seen = {}

    def __enter__(self):
        build, pull = self.real

        def watched_build(mesh, centers, valid, csp):
            self.seen.update(centers=centers.clone(), valid=valid.clone(),
                             csp=csp)
            return build(mesh, centers, valid, csp)

        def watched_pull(*args):
            self.seen["table"] = pull(*args)
            return self.seen["table"]

        self.lut.build_lut_enc_sharded = watched_build
        self.lut.pull_lut_sharded = watched_pull
        return self.seen

    def __exit__(self, *exc):
        self.lut.build_lut_enc_sharded, self.lut.pull_lut_sharded = self.real


def _single_table(seen):
    """The single-device K5 table for the palette a sharded build got."""
    from patolette_tpu_torch.ops import lut

    table = lut.build_lut_device(seen["centers"], seen["valid"],
                                 seen["csp"]).cpu().numpy()
    lut.clear_grid_cache()
    return table


def phase_e2e_mesh(torch, img_100mp, mse_headline, profile=False):
    """quantize(mesh=) with one rank: a world-1 NCCL group in this process
    on cuda:0. The 4K uint8 undithered call (the sharded 24-bit table:
    K10, K5, K6), the 4K float32 undithered call (K3 on the strip), the
    4K default call (saliency and dither per strip: K9, K7, K8) and
    bench.py's 100 MP uint8 image."""
    import numpy as np
    import torch.distributed as dist

    import patolette_tpu_torch as pt
    from patolette_tpu_torch.ops import lut
    from patolette_tpu_torch.parallel import distributed as D

    cpus_before = len(os.sched_getaffinity(0))
    mesh = D.init_distributed(f"tcp://localhost:{_free_port()}", 1, 0,
                              backend="nccl", device="cuda:0")
    w, h, p = W, H, 256
    img = synth_image_f32(w, h)
    img_u8 = np.round(img * 255.0).astype(np.uint8)
    x8 = img_u8.astype(np.float32) / np.float32(255.0)
    undithered = dict(dither=False, tile_size=0, kmeans_niter=32,
                      color_space=pt.ColorSpace_ICtCp)
    out = {"launches": {}, "mse": {}}
    try:
        def mesh_run(kw, ww=w, hh=h):
            def run(colors, **extra):
                ok, pal, pmap, msg = pt.quantize(ww, hh, colors, p, mesh=mesh,
                                                 **kw, **extra)
                check(ok, f"mesh quantize failed: {msg}")
                return pal, pmap
            return run

        def single(colors, kw):
            """The single-device call on the same pixels, twice, timed: with
            the group up, beside the mesh call's walls."""
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                ok, pal, pmap, msg = pt.quantize(w, h, colors, p, **kw)
                walls.append(time.perf_counter() - t0)
                check(ok, f"single-device quantize failed: {msg}")
            out.setdefault("single_wall_s", []).append(walls)
            return pal, pmap

        # 4K uint8, undithered: the sharded table
        lut.clear_grid_cache()
        run = mesh_run(undithered)
        pal8, pmap8, st8 = _drive(torch, run, img_u8, MESH_U8_KERNELS,
                                  "the mesh uint8 call")
        check(st8["launches"]["assign_planar"] == 0, "K3 on the mesh table")
        check(set(st8["stage_ms"]) == MESH_LAPS, f"laps {st8['stage_ms']}")
        _check_outputs(pal8, pmap8, p, w * h)
        with _TableWatch() as seen:
            pal8b, pmap8b = run(img_u8)
        ref = _single_table(seen)
        check(np.array_equal(seen["table"], ref),
              "the sharded table differs from the single-device K5 table")
        check(np.array_equal(pmap8b, lut.lut_map_host(img_u8, ref)),
              "the mesh map differs from the host map through the table")
        check(np.array_equal(pmap8b, pmap8), "mesh uint8 reruns differ")
        mse8 = _mse_luv(torch, x8, pal8, pmap8)[0]
        ref8 = _mse_luv(torch, x8, *single(img_u8, undithered))[0]
        out["launches"]["mesh-u8"] = st8["launches"]
        out["mse"]["u8"] = mse8
        emit({"phase": "e2e-mesh-u8", "shape": [w, h], "palette": p,
              "world": 1, "backend": "nccl", "cpus_before_group":
              cpus_before, "cpus_with_group": len(os.sched_getaffinity(0)),
              "single_device_wall_s": out["single_wall_s"][-1], **st8,
              "mp_per_s": w * h / 1e6 / st8["best_s"], "cieluv_mse": mse8,
              "cieluv_mse_single_device": ref8,
              "mse_ratio_to_single_device": mse8 / ref8,
              "table_equals_single_device": True,
              "bit_identical_runs": True})
        check(mse8 <= MESH_MSE_RATIO * ref8, f"mesh uint8 MSE {mse8} / {ref8}")
        if profile:
            _profile_call(torch, lambda: run(img_u8), "mesh_u8")
        lut.clear_grid_cache()

        # 4K float32, undithered: K10 + K3 on the strip
        pal, pmap, st = _drive(torch, run, img, MESH_F32_KERNELS,
                               "the mesh float32 call")
        check(st["launches"]["rle_encode_u8_v2"] == 0, "K6 on the float call")
        check(set(st["stage_ms"]) == MESH_LAPS, f"laps {st['stage_ms']}")
        _check_outputs(pal, pmap, p, w * h)
        mse = _mse_luv(torch, img, pal, pmap)[0]
        ref = _mse_luv(torch, img, *single(img, undithered))[0]
        out["launches"]["mesh-f32"] = st["launches"]
        emit({"phase": "e2e-mesh-f32", "shape": [w, h], "palette": p,
              "world": 1, "single_device_wall_s": out["single_wall_s"][-1],
              **st, "mp_per_s": w * h / 1e6 / st["best_s"],
              "cieluv_mse": mse, "cieluv_mse_single_device": ref,
              "mse_ratio_to_single_device": mse / ref,
              "bit_identical_runs": True})
        check(mse <= MESH_MSE_RATIO * ref, f"mesh float MSE {mse} / {ref}")

        # 4K default call: saliency and dither on the strip
        run = mesh_run({})
        pal, pmap, st = _drive(torch, run, img, MESH_DEFAULT_KERNELS,
                               "the mesh default call")
        check(set(st["stage_ms"]) == MESH_DEFAULT_LAPS,
              f"laps {st['stage_ms']}")
        _check_outputs(pal, pmap, p, w * h)
        quality = _dither_quality(torch, img, pal, pmap, w, h,
                                  "mesh default call")
        ref = _mse_luv(torch, img, *single(img, {}))[0]
        out["launches"]["mesh-default"] = st["launches"]
        out["mse"]["default"] = quality["cieluv_mse"]
        emit({"phase": "e2e-mesh-default", "shape": [w, h], "palette": p,
              "world": 1, "single_device_wall_s": out["single_wall_s"][-1],
              **st, "mp_per_s": w * h / 1e6 / st["best_s"],
              **quality, "cieluv_mse_single_device": ref,
              "mse_ratio_to_single_device": quality["cieluv_mse"] / ref,
              "bit_identical_runs": True})
        check(quality["cieluv_mse"] <= MESH_MSE_RATIO * ref,
              f"mesh default MSE {quality['cieluv_mse']} / {ref}")
        for seed in MESH4_SEEDS[1:]:  # world 1's side of e2e-mesh-4
            out["mse"][f"default_seed{seed}"] = _mse_luv(
                torch, img, *run(img, seed=seed))[0]

        (out["launches"]["mesh-palette"], out["mse"]["palette"],
         out["mse"]["palette_dithered"]) = _mesh_palette_world1(
             torch, mesh, img, p)

        # bench.py's 100 MP uint8 image, 25 iterations
        hw, hh = HEADLINE_W, HEADLINE_H
        run = mesh_run(dict(undithered, kmeans_niter=25), hw, hh)
        pal, pmap, st = _drive(torch, run, img_100mp, MESH_U8_KERNELS,
                               "the mesh 100 MP call")
        check(st["launches"]["assign_planar"] == 0, "K3 on the 100 MP mesh")
        _check_outputs(pal, pmap, p, hw * hh)
        idx = np.random.default_rng(1).integers(0, hw * hh, size=1 << 20)
        sub = img_100mp[idx].astype(np.float32) / np.float32(255.0)
        mse = _mse_luv(torch, sub, pal, pmap[idx])[0]
        emit({"phase": "e2e-mesh-headline", "shape": [hw, hh], "palette": p,
              "kmeans_niter": 25, "world": 1, **st,
              "mp_per_s": hw * hh / 1e6 / st["best_s"],
              "cieluv_mse_1m": mse, "cieluv_mse_1m_single_device":
              mse_headline, "mse_ratio_to_single_device": mse / mse_headline,
              "bit_identical_runs": True})
        check(mse <= MESH_MSE_RATIO * mse_headline,
              f"mesh 100 MP MSE {mse} / {mse_headline}")
        lut.clear_grid_cache()
    finally:
        dist.destroy_process_group()
    return out


MESH_PALETTE_KERNELS = ("gq_dp", "segment_sum", "lq_candidates",
                        "kmeans_step", "color_convert", "assign_planar")
# quantize_palette_distributed's call with draws, on one rank and on four
MESH_PALETTE_KW = dict(kmeans_niter=32, lq_max_samples=N_SAMPLES,
                       planar=True)


def _palette_and_dither(torch, mesh, chans, w, h, p):
    """quantize_palette_distributed (MESH_PALETTE_KW) then
    dither_distributed of this rank's channels on its palette: the
    palette and valid flags, this rank's maps, the call's launches."""
    from patolette_tpu_torch import kernels
    from patolette_tpu_torch.parallel import distributed as D

    reset_launches()
    centers, valid, pmap = D.quantize_palette_distributed(
        mesh, p, **MESH_PALETTE_KW)(chans, None)
    dmap = D.dither_distributed(mesh, w, h, 2, planar=True)(chans, centers,
                                                           valid)
    torch.cuda.synchronize()
    return centers, valid, pmap, dmap, dict(kernels.LAUNCHES)


def _mse_working(torch, img, centers, valid, pmap):
    """CIELuv MSE of a working-space (ICtCp) palette's map."""
    from patolette_tpu_torch.models import pipeline

    pal = pipeline._finish_palette(centers, valid, len(valid), 2)
    return _mse_luv(torch, img, pal, pmap.cpu().numpy())[0]


def _mesh_palette_world1(torch, mesh, img, p):
    """e2e-mesh-palette: quantize_palette_distributed, the first caller of
    palette_pipeline_device(mesh=), with one rank. Without draws it must
    equal palette_pipeline_device without a mesh, bit for bit (one rank's
    exchange is exact); then the 32-iteration call with draws, timed, with
    its launches (K11 on the mesh), and dither_distributed on its palette:
    world 1's side of e2e-mesh-4."""
    from patolette_tpu_torch import kernels
    from patolette_tpu_torch.models import pipeline
    from patolette_tpu_torch.parallel import distributed as D

    w, h = W, H
    chans = tuple(torch.from_numpy(img[:, k].copy()).to(DEV)
                  for k in range(3))
    no_draws = dict(kmeans_niter=0, lq_max_samples=0)
    reset_launches()
    t0 = time.perf_counter()
    got = D.quantize_palette_distributed(mesh, p, planar=True, **no_draws)(
        chans, None)
    torch.cuda.synchronize()
    no_draws_s = time.perf_counter() - t0
    no_draws_launches = dict(kernels.LAUNCHES)
    want = pipeline.palette_pipeline_device(chans, None, p, **no_draws)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "quantize_palette_distributed on one rank differs from "
          "palette_pipeline_device")
    walls, first = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        res = _palette_and_dither(torch, mesh, chans, w, h, p)
        walls.append(time.perf_counter() - t0)
        first = first or res
        check(all(torch.equal(a, b) for a, b in zip(res[:4], first[:4])),
              "two runs of quantize_palette_distributed differ")
    centers, valid, pmap, dmap, launches = first
    for name in MESH_PALETTE_KERNELS + ("visit_order", "dither_scan"):
        check(launches[name] > 0, f"{name} not launched on the mesh palette")
    mse = _mse_working(torch, img, centers, valid, pmap)
    mse_d = _mse_working(torch, img, centers, valid, dmap)
    emit({"phase": "e2e-mesh-palette", "shape": [w, h], "palette": p,
          "world": 1, "backend": "nccl", **MESH_PALETTE_KW,
          "equals_palette_pipeline_device_no_draws": True,
          "no_draws_s": no_draws_s,
          "no_draws_launches": {k: v for k, v in no_draws_launches.items()
                                if v},
          "palette_and_dither_wall_s": walls,
          "launches": {k: v for k, v in launches.items() if v},
          "palette_used": int(valid.sum()), "cieluv_mse": mse,
          "cieluv_mse_dithered": mse_d, "bit_identical_runs": True})
    return launches, mse, mse_d


def mesh_worker(port, rank, world, out_dir):
    """One rank of e2e-mesh-4 (``chip_smoke.py --mesh-worker PORT RANK
    WORLD DIR``): gloo, every rank on cuda:0; the 4K uint8 undithered call
    and the 4K default call, each three times, then the default call at
    the other seeds of MESH4_SEEDS and without saliency, once each, then
    one quantize_palette_distributed + dither_distributed call on the
    rank's rows; results into DIR/rRANK.npz."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    import patolette_tpu_torch as pt
    from patolette_tpu_torch import kernels
    from patolette_tpu_torch.models import pipeline
    from patolette_tpu_torch.parallel import distributed as D
    from patolette_tpu_torch.parallel import mesh as PM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = D.init_distributed(f"tcp://localhost:{port}", int(world),
                              int(rank), backend="gloo", device="cuda:0",
                              timeout=datetime.timedelta(seconds=120))
    img = synth_image_f32(W, H)
    img_u8 = np.round(img * 255.0).astype(np.uint8)
    res, meta = {}, {}
    for tag, colors, kw in (
            ("u8", img_u8, dict(dither=False, tile_size=0, kmeans_niter=32,
                                color_space=pt.ColorSpace_ICtCp)),
            ("default", img, {})):
        walls = []
        for i in range(3):
            reset_launches()
            t0 = time.perf_counter()
            with _TableWatch() as seen:
                ok, pal, pmap, msg = pt.quantize(W, H, colors, 256,
                                                 mesh=mesh, **kw)
            walls.append(time.perf_counter() - t0)
            check(ok, f"rank {rank} {tag}: {msg}")
            if i == 1:
                meta[tag] = {"launches": dict(kernels.LAUNCHES),
                             "stage_ms": dict(pipeline.LAST_STAGE_TIMES)}
                res[tag + "_pal"], res[tag + "_map"] = pal, pmap
            elif i == 2:
                check(np.array_equal(pal, res[tag + "_pal"])
                      and np.array_equal(pmap, res[tag + "_map"]),
                      f"rank {rank} {tag}: reruns differ")
        meta[tag]["wall_s"] = walls
        if "table" in seen:
            res["table"] = seen["table"]
            res["centers"] = seen["centers"].cpu().numpy()
            res["valid"] = seen["valid"].cpu().numpy()
    # the default call at the other seeds, and without saliency (what the
    # MSE bound against world 1 would see if the saliency went missing)
    for tag, kw in [(f"default_seed{s}", dict(seed=s))
                    for s in MESH4_SEEDS[1:]] + [("no_saliency",
                                                  dict(tile_size=0))]:
        ok, pal, pmap, msg = pt.quantize(W, H, img, 256, mesh=mesh, **kw)
        check(ok, f"rank {rank} {tag}: {msg}")
        res[tag + "_pal"], res[tag + "_map"] = pal, pmap
    # quantize_palette_distributed and dither_distributed on this rank's
    # rows: the palette the same bits on every rank, the maps this rank's
    # rows of the gathered whole
    lo, hi = PM.shard_range(W * H, mesh)
    chans = tuple(torch.from_numpy(img[lo:hi, k].copy()).to(mesh.device)
                  for k in range(3))
    t0 = time.perf_counter()
    centers, valid, pmap, dmap, launches = _palette_and_dither(
        torch, mesh, chans, W, H, 256)
    meta["palette"] = {"wall_s": time.perf_counter() - t0,
                       "launches": launches}
    whole, dwhole = PM.gather(mesh, pmap), PM.gather(mesh, dmap)
    check(torch.equal(whole[lo:hi], pmap) and torch.equal(dwhole[lo:hi],
                                                          dmap),
          f"rank {rank}: its maps are not its rows of the gathered whole")
    res.update(qpd_centers=centers.cpu().numpy(),
               qpd_valid=valid.cpu().numpy(), qpd_map=whole.cpu().numpy(),
               qpd_dither_map=dwhole.cpu().numpy())
    meta["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    np.savez(pathlib.Path(out_dir) / f"r{rank}.npz", **res)
    (pathlib.Path(out_dir) / f"r{rank}.json").write_text(json.dumps(meta))
    dist.destroy_process_group()
    return 0


def phase_e2e_mesh4(torch, mse_world1):
    """Four ranks sharing cuda:0 over a gloo group (NCCL takes one rank a
    GPU): every rank's palette and map identical, K6 launched on every
    rank, the assembled table equal to the single-device K5 table for the
    palette, and the MSE against world 1's."""
    import shutil

    import numpy as np

    world = 4
    out_dir = ROOT / "build" / "mesh4"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-worker",
         str(port), str(r), str(world), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - t0
    for r, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0, f"mesh rank {r} failed:\n{log[-3000:]}")
    res = [dict(np.load(out_dir / f"r{r}.npz")) for r in range(world)]
    meta = [json.loads((out_dir / f"r{r}.json").read_text())
            for r in range(world)]
    for r in range(1, world):
        for key in res[0]:
            check(np.array_equal(res[r][key], res[0][key]),
                  f"rank {r} differs from rank 0 in {key}")
    for r, m in enumerate(meta):
        for name in MESH_U8_KERNELS:
            check(m["u8"]["launches"][name] > 0,
                  f"rank {r}: {name} not launched on the uint8 call")
        for name in MESH_DEFAULT_KERNELS:
            check(m["default"]["launches"][name] > 0,
                  f"rank {r}: {name} not launched on the default call")
    seen = {"centers": torch.from_numpy(res[0]["centers"]).to(DEV),
            "valid": torch.from_numpy(res[0]["valid"]).to(DEV), "csp": 2}
    check(np.array_equal(res[0]["table"], _single_table(seen)),
          "the four ranks' table differs from the single-device K5 table")
    img = synth_image_f32(W, H)
    x8 = np.round(img * 255.0).astype(np.uint8)
    mse8 = _mse_luv(torch, x8.astype(np.float32) / np.float32(255.0),
                    res[0]["u8_pal"], res[0]["u8_map"])[0]
    quality = _dither_quality(torch, img, res[0]["default_pal"],
                              res[0]["default_map"], W, H,
                              "world-4 default call")
    mse_d = quality["cieluv_mse"]
    ratios = {MESH4_SEEDS[0]: mse_d / mse_world1["default"]}
    for seed in MESH4_SEEDS[1:]:
        tag = f"default_seed{seed}"
        ratios[seed] = _mse_luv(torch, img, res[0][tag + "_pal"],
                                res[0][tag + "_map"])[0] / mse_world1[tag]
    no_sal = _mse_luv(torch, img, res[0]["no_saliency_pal"],
                      res[0]["no_saliency_map"])[0]
    for r, m in enumerate(meta):
        for name in MESH_PALETTE_KERNELS + ("visit_order", "dither_scan"):
            check(m["palette"]["launches"][name] > 0,
                  f"rank {r}: {name} not launched on the mesh palette")
    q = [torch.from_numpy(res[0][k]) for k in ("qpd_centers", "qpd_valid")]
    mse_q = _mse_working(torch, img, *q, torch.from_numpy(res[0]["qpd_map"]))
    mse_qd = _mse_working(torch, img, *q,
                          torch.from_numpy(res[0]["qpd_dither_map"]))
    emit({"phase": "e2e-mesh-4", "shape": [W, H], "palette": 256,
          "world": world, "backend": "gloo", "devices": "cuda:0 shared",
          "seconds": secs, "walls_s": {
              tag: [m[tag]["wall_s"] for m in meta]
              for tag in ("u8", "default")},
          "stage_ms_rank0": {tag: meta[0][tag]["stage_ms"]
                             for tag in ("u8", "default")},
          "launches_rank0": {tag: meta[0][tag]["launches"]
                             for tag in ("u8", "default")},
          "peak_device_bytes": [m["peak_device_bytes"] for m in meta],
          "cieluv_mse_u8": mse8,
          **{"default_" + k: v for k, v in quality.items()},
          "mse_ratio_to_world1_u8": mse8 / mse_world1["u8"],
          "mse_ratio_to_world1_default": mse_d / mse_world1["default"],
          "mse_ratio_to_world1_default_by_seed": ratios,
          "no_saliency_mse_ratio_to_world1_default":
              no_sal / mse_world1["default"],
          "ranks_identical": True, "table_equals_single_device": True,
          "palette_wall_s": [m["palette"]["wall_s"] for m in meta],
          "palette_launches_rank0": meta[0]["palette"]["launches"],
          "palette_cieluv_mse": mse_q, "palette_cieluv_mse_dithered": mse_qd,
          "palette_mse_ratio_to_world1": mse_q / mse_world1["palette"],
          "palette_dithered_mse_ratio_to_world1":
              mse_qd / mse_world1["palette_dithered"]})
    check(mse_q <= MESH4_PALETTE_RATIO * mse_world1["palette"],
          f"world-4 palette MSE {mse_q} against world 1's")
    check(mse_qd <= MESH4_DEFAULT_RATIO * mse_world1["palette_dithered"],
          f"world-4 palette dithered MSE {mse_qd} against world 1's")
    check(mse8 <= MESH_MSE_RATIO * mse_world1["u8"],
          f"world-4 uint8 MSE {mse8} against world 1's")
    for seed, ratio in ratios.items():
        check(ratio <= MESH4_DEFAULT_RATIO,
              f"world-4 default MSE {ratio}x world 1's at seed {seed}")
    return {"mesh4-u8": meta[0]["u8"]["launches"]}


def phase_golden(torch):
    """Small-input reference: the four golden configs."""
    import numpy as np

    import patolette_tpu_torch as pt

    golden = np.load(ROOT / "tests" / "golden" / "quantize_golden.npz")
    out = {"phase": "golden"}
    for name, p, kw in (
        ("cieluv_plain", 32, dict(dither=False, tile_size=0, kmeans_niter=0,
                                  color_space=pt.ColorSpace_CIELuv)),
        ("ictcp_kmeans8", 24, dict(dither=False, tile_size=0, kmeans_niter=8,
                                   color_space=pt.ColorSpace_ICtCp)),
        ("srgb_saliency", 16, dict(dither=False, tile_size=256,
                                   kmeans_niter=0,
                                   color_space=pt.ColorSpace_sRGB)),
        ("ictcp_dither", 16, dict(dither=True, tile_size=0, kmeans_niter=4,
                                  color_space=pt.ColorSpace_ICtCp)),
    ):
        ok, pal, pmap, msg = pt.quantize(96, 64, _golden_image(), p, **kw)
        check(ok, msg)
        err = float(np.abs(pal - golden[f"{name}__palette"]).max())
        hist = np.bincount(pmap, minlength=p)
        moved = int(np.abs(hist - golden[f"{name}__hist"]).sum())
        out[name] = {"palette_max_abs_err": err, "hist_l1": moved}
        # the card sums in another order than the CPU: a palette entry
        # may move by a few ulps of the PQ curve, a handful of pixels
        # may change entry at near-ties; under the dither a changed
        # near-tie carries on down the error queue, so more pixels move
        limit = 0.02 if kw["dither"] else 0.005
        check(err <= 1e-3, f"golden {name}: palette deviates {err}")
        check(moved <= limit * len(pmap), f"golden {name}: {moved} moved")
    emit(out)


# kernel -> (source, the JAX function it replaces, the path it belongs to)
SOURCES = {
    "segment_sum": ("patolette_tpu_torch/csrc/segment_sum.cu",
                    "patolette_tpu/ops/moments.py:108", "main"),
    "lq_candidates": ("patolette_tpu_torch/csrc/lq_candidates.cu",
                      "patolette_tpu/models/local_q.py:87", "main"),
    "assign_planar": ("patolette_tpu_torch/csrc/assign.cu",
                      "patolette_tpu/ops/assign.py:81", "main"),
    "kmeans_step": ("patolette_tpu_torch/csrc/kmeans.cu",
                    "patolette_tpu/models/kmeans.py:104", "main"),
    "lut_argmin": ("patolette_tpu_torch/csrc/lut.cu",
                   "patolette_tpu/ops/lut.py:145", "u8-lut"),
    "visit_order": ("patolette_tpu_torch/csrc/hilbert.cu",
                    "patolette_tpu/ops/hilbert.py:62", "default"),
    "dither_scan": ("patolette_tpu_torch/csrc/dither.cu",
                    "patolette_tpu/models/dither.py:144", "default"),
    "mbd": ("patolette_tpu_torch/csrc/mbd.cu",
            "patolette_tpu/models/saliency.py:62", "default"),
    "color_convert": ("patolette_tpu_torch/csrc/colorspace.cu",
                      "patolette_tpu/ops/colorspace.py:353", "main"),
    "rle_encode_u8_v2": ("patolette_tpu_torch/csrc/rle.cu",
                         "patolette_tpu/ops/lut.py:206", "u8-lut"),
    "rle_encode_u8": ("patolette_tpu_torch/csrc/rle.cu",
                      "patolette_tpu/ops/lut.py:187", "u8-lut-v1"),
    "rle_encode_u16_v2": ("patolette_tpu_torch/csrc/rle.cu",
                          "patolette_tpu/ops/lut.py:270", "u16-lut"),
    "gq_dp": ("patolette_tpu_torch/csrc/gq_dp.cu",
              "patolette_tpu/models/global_q.py:205", "u8-lut"),
}


# kernel rows of another instantiation, counted on the path that runs it
ROW_PATHS = {"lut_argmin[1024]": "u16-lut",
             "visit_order[strip]": "strip-u8",
             "rle_encode_u8_v2[quarter]": "mesh4-u8",
             "rle_encode_u8[alternating]": "pull-u8-raw",
             "rle_encode_u16_v2[block]": "pull-u16-raw",
             **{row[0]: row[4] for row in K10_ROWS}}
ROW_REPLACES = {row[0]: row[5] for row in K10_ROWS}


def main():
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(*sys.argv[2:6])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    root = (pathlib.Path(args[args.index("--root") + 1]).resolve()
            if "--root" in args else ROOT)
    if not (root / "patolette_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device(torch)
    phase_build()
    if ("--split" in args or "--laps" in args or "--spans" in args
            or "--lq-graph" in args):
        (phase_split if "--split" in args else
         phase_laps if "--laps" in args else
         phase_spans if "--spans" in args else phase_lq_graph)(torch)
        print(nvidia_smi_line(), flush=True)
        return 0
    rows, tables = phase_kernels(torch)
    pull_launches = phase_pull(torch, tables)
    del tables
    profile = "--profile" in sys.argv[1:]
    main_launches, u8_launches, peak_u8, mse_resident = phase_e2e(
        torch, profile=profile)
    launches = {"main": main_launches, "u8-lut": u8_launches,
                "u8-lut-v1": phase_e2e_u8_ramp(torch),
                "default": phase_e2e_default(torch, profile=profile),
                **pull_launches}
    launches["one-shot"], launches["one-shot-default"] = phase_e2e_one_shot(
        torch, profile=profile)
    phase_api(torch)
    launches["image-fused-lut"] = phase_e2e_image_fused_lut(torch)
    img_100mp, launches["u16-lut"], mse_headline = phase_e2e_headline(
        torch, peak_u8)
    launches["strip-dither"] = phase_e2e_strip_dither(torch, profile=profile)
    launches["strip-u8"] = phase_e2e_strip_headline(torch, img_100mp)
    launches["over-budget"] = phase_e2e_over_budget(torch, mse_resident)
    mesh = phase_e2e_mesh(torch, img_100mp, mse_headline, profile=profile)
    launches.update(mesh["launches"])
    launches.update(phase_e2e_mesh4(torch, mesh["mse"]))
    phase_golden(torch)
    if "--routes" in sys.argv[1:]:
        phase_routes(torch, img_100mp)
    del img_100mp
    phase_split(torch)

    line = []
    for r in rows:
        key = r["name"].split("[")[0]
        src, replaces, path = SOURCES[key]
        path = ROW_PATHS.get(r["name"], path)
        line.append({
            "name": r["name"], "route": "cuda", "source": src,
            "replaces": ROW_REPLACES.get(r["name"], replaces),
            "launches": launches[path][key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("candidates", "pow_fallback") if k in r},
        })
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
