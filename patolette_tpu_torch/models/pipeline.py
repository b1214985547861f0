"""Quantization pipeline: the public ``quantize`` API of the port.

Its routes, chosen as the JAX package's ``_quantize_body`` chooses them
(pipeline.py:1003-1161), its environment flags included:

* **Sampled** (``_quantize_via_samples``): uint8 undithered images
  without saliency of at least 4 MP, and every ``palette_only`` call
  without saliency. Only the host-drawn palette samples go to the device
  (``_draw_palette_samples``, the JAX package's exact draws including the
  S11 reuse). A mapped call of at most 256 colours runs the fused program
  (``_sample_lut_program``, the JAX package's): K10 to the working space,
  the palette core (K1, the GQ DP on the device (K11), K2, K4), the sRGB
  pack, K5's u8 table over the cached ICtCp grid and its v2 encoding
  (K6), with nothing read back until the pack and the table's words come
  back; on v2's overflow the table comes back as v1 words or raw. Under
  ``PATOLETTE_NO_FUSED_LUT``, for ``palette_only`` and for u16 tables it
  runs staged, as the JAX package does: GQ with the DP on the host in f64,
  LQ, KMeans, then ``LUT.pull_lut``. The host resolves every pixel through
  the table (``ops/lut.py``). Nothing of size N is on the device, so the
  device budget does not bound these calls.
* **Streamed** (``_quantize_streamed``, the JAX package's): the palette
  from the same samples by the fused program without the table
  (``_sample_palette_program``), then the map per row strip with one
  strip on the device at a time: upload, K10, then K3 (undithered) or K7
  + K8 (dither, each strip with its own curve and a fresh error queue at
  its seam). Dithered calls without saliency above 4 MP take it (unless
  ``PATOLETTE_NO_STRIP_DITHER`` is set), and so does any call without
  saliency whose resident footprint exceeds the device budget or that
  runs out of device memory on the resident route.
* **Full-image fused LUT** (``_quantize_image_fused_lut``, the JAX
  package's; opt-in under ``PATOLETTE_FUSED_IMAGE_LUT=1``): uint8
  undithered calls of at most 256 colours and at least 4 MP off the
  sampled route (saliency or explicit weights), within the device budget.
  The image goes up, then saliency (K9), K10, the palette core with its
  device draws, the pack, K5 and K6, and the pulls of the sampled fused
  program.
* **One-shot** (``_quantize_one_shot``, the JAX package's): images of at
  most ``ONE_SHOT_MAX_PIXELS`` (4 MP) off the routes above, unless
  ``PATOLETTE_NO_ONE_SHOT`` is set. The image goes up, then saliency (K9),
  K10 to the working space and the palette core (``_palette_core``:
  device draws, K1 moments, K11, LQ with its control on the device (K2
  with K1), centres, KMeans (K4)), then the dither (K7, K8) or the direct
  map (K3); nothing is read back until the palette and the map come back
  together at the end. ``palette_pipeline_device`` is the same core as a
  function of tensors.
* **Resident** (``_quantize_resident``, modelled on
  ``_quantize_full_upload``; above 4 MP, or under
  ``PATOLETTE_NO_ONE_SHOT``): sRGB -> weights (explicit, else MBD saliency
  with K9 when ``tile_size > 0``) -> working space -> LQ sample draw -> GQ
  (the host f64 DP, as the JAX package's staged route) -> LQ -> centres
  (K1) -> KMeans (K4) -> Riemersma dither (K7 curve order, K8 scan) or the
  ICtCp direct map (K3) -> sRGB palette with [-1, -1, -1] fill. The image
  goes up as it is (uint8 as bytes) and K10 turns it into three planar f32
  channels of the working space, which stay on the device. The JAX
  package maps uint8 undithered images of at least 4 MP on this route
  through its 24-bit table, to spare the index download over its host
  link; the table equals the direct map, so the port keeps K3.
* **Sharded** (``_quantize_sharded``, the JAX package's): with ``mesh=``
  (``parallel/mesh.py``), when the pixels (and, for a dither, the rows)
  divide over the ranks. Each rank holds a contiguous row strip on its
  device; saliency and the dither run per strip; the palette is
  ``PM.quantize_palette_sharded`` on the strips: the palette core with
  every sum reduced over the ranks and K11 on the reduced moments; the map
  is that program's K3 per strip, or, for uint8 undithered calls of at
  least 4 MP, the 24-bit table built in slices (K5 and K6 per rank) and
  resolved on every rank's host. ``parallel/distributed.py`` gives the
  same route one call per process on the rank's rows alone.

Draws: the sampled and streamed routes draw their samples on the host from
``np.random.default_rng(seed)``, as the JAX package does. The resident
route's LQ draw is the JAX package's exact draw; its KMeans draw follows
from the same ``rng`` where the JAX package draws with ``jax.random``
(README divergence T1). The one-shot, full-image LUT and sharded routes
draw on the device from ``torch.Generator``s seeded from ``(seed,
stream)`` (``(seed, rank, stream)`` on the mesh) where the JAX package
draws with ``jax.random`` from its key folded the same way (README T5,
T6).

Over the device budget, calls with saliency or with ``lq_max_samples=0``
fail typed, as in the JAX package; the sharded route has no budget check,
as in the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time
import traceback

import numpy as np
import torch

from patolette_tpu_torch.kernels.colorspace import color_convert
from patolette_tpu_torch.kernels.rle import buffer_words, rle_encode_u8_v2
from patolette_tpu_torch.models import dither as DITH
from patolette_tpu_torch.models import global_q as GQ
from patolette_tpu_torch.models import kmeans as KM
from patolette_tpu_torch.models import local_q as LQ
from patolette_tpu_torch.models import palette as PAL
from patolette_tpu_torch.models import saliency as SAL
from patolette_tpu_torch.ops import colorspace as cs
from patolette_tpu_torch.ops import eigen3
from patolette_tpu_torch.ops import lut as LUT
from patolette_tpu_torch.ops import moments as M
from patolette_tpu_torch.ops.assign import assign_planar
from patolette_tpu_torch.parallel import mesh as PM
from patolette_tpu_torch.utils import errors
from patolette_tpu_torch.utils.config import ColorSpace, QuantizeOptions
from patolette_tpu_torch.utils.device import (call_device, on_device,
                                              resolve_device)
from patolette_tpu_torch.utils.spans import span

# Per-stage wall times (ms) of the most recent quantize() call.
LAST_STAGE_TIMES: dict[str, float] = {}

# Laps that wait for the device, so each holds its own device time: on for
# every call under PATOLETTE_SYNC_STAGES=1 or set_sync_stages(True), as in
# the JAX package (pipeline.py:66-79); a call turns it on for itself with
# sync_stages=True or verbose. It costs the overlap of host and device, so
# timed runs leave it off.
_SYNC_STAGES = os.environ.get("PATOLETTE_SYNC_STAGES", "0") == "1"


def set_sync_stages(on: bool) -> bool:
    """Turn synced stage laps on or off for every later call; returns the
    previous setting."""
    global _SYNC_STAGES
    prev = _SYNC_STAGES
    _SYNC_STAGES = bool(on)
    return prev

# Peak device bytes per pixel of one resident call, measured
# (torch.cuda.max_memory_allocated over a 3840x2160 float32 call on an
# NVIDIA H100 80GB HBM3, chip_smoke.py's e2e phases) and rounded up: 28.1
# for the direct map (the image as uploaded, its working planes, the map)
# and 102.4 with saliency and dither (the MBD's planes and the priors,
# then the linear Rec2020 planes, the curve keys, their sort and the
# permutation).
BYTES_PER_PIXEL = 29
BYTES_PER_PIXEL_SALIENCY_OR_DITHER = 103
# The same for the one-shot route, measured over its 2048x2048 calls
# (chip_smoke.py's e2e-one-shot phases, the same card): 33.2 undithered
# and 107.7 with saliency and dither (the palette core's draws and tables
# beside the resident route's planes).
ONE_SHOT_BYTES_PER_PIXEL = 34
ONE_SHOT_BYTES_PER_PIXEL_SALIENCY_OR_DITHER = 108
# The opt-in full-image fused LUT route (PATOLETTE_FUSED_IMAGE_LUT=1),
# measured the same way over its 3840x2160 uint8 call with saliency
# (chip_smoke.py's e2e-image-fused-lut, the same card): 102.5 bytes a pixel
# above the grid, the table and its words, which do not grow with N (the
# saliency planes, then the palette core's beside the uploaded bytes).
IMAGE_LUT_BYTES_PER_PIXEL = 103
IMAGE_LUT_FIXED_BYTES = (3 * 4 + 1) * LUT.LUT_SIZE + 2 * buffer_words(
    LUT.LUT_SIZE)
# Beside each route's bytes above, whatever N: what the LQ graphs hold on
# the card from call to call (local_q.GRAPH_HELD_BYTES, ~5.5 MB), taken
# off the device budget.
LQ_GRAPH_BYTES = LQ.GRAPH_HELD_BYTES
DEVICE_BUDGET_FRACTION = 0.8

# The JAX package's thresholds of the sampled route (pipeline.py:210-217).
# They stay its values: the route decides which pixels KMeans sees (S11),
# so another threshold would give another palette, not only another speed.
LUT_MIN_PIXELS = 1 << 22
SAMPLE_MAX = 1 << 22

# The streamed route's strips: the JAX package's sizes (pipeline.py:635-640).
# The strip rows, each strip's own Hilbert curve and the fresh error queue
# at each seam decide the dithered map, so another size would give another
# map, not only another speed.
STREAM_STRIP_MIN = 1 << 22
STREAM_STRIP_MAX = 1 << 24
# Images of at most this many pixels take the one-shot route: the JAX
# package's ONE_SHOT_MAX_PIXELS (pipeline.py:778).
ONE_SHOT_MAX_PIXELS = 1 << 22
# Dithered calls without saliency above this many pixels stream per strip
# whatever the budget: where the one-shot route ends, as in the JAX
# package (pipeline.py:1042-1059); the value keeps the JAX package's maps.
STRIP_DITHER_MIN_PIXELS = ONE_SHOT_MAX_PIXELS


def _stream_strip_pixels(n: int) -> int:
    return min(max(n // 2, STREAM_STRIP_MIN), STREAM_STRIP_MAX)


def _lut_min_pixels(palette_size: int) -> int:
    if palette_size <= 256:
        return LUT_MIN_PIXELS
    return LUT.LUT_SIZE * LUT.lut_dtype(palette_size).itemsize


def _log(verbose, msg):
    if verbose:
        print(f"patolette ======== {msg}", flush=True)


class _StageTimer:
    """Per-stage wall clock into ``LAST_STAGE_TIMES``, each stage also a
    span in the profiler's timeline. With ``sync`` (on under verbose) each
    lap first waits for the device, so a lap holds its own device time;
    otherwise laps time the host's enqueue."""

    def __init__(self, verbose, sync, device):
        self.verbose = verbose
        self.sync = sync and device.type == "cuda"
        self.device = device
        self.t = time.perf_counter()
        self.laps: dict[str, float] = {}
        global LAST_STAGE_TIMES
        LAST_STAGE_TIMES = self.laps

    def lap(self, name):
        """Add the time since the previous lap to the lap ``name``."""
        if self.sync:
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        ms = 1e3 * (now - self.t)
        self.laps[name] = self.laps.get(name, 0.0) + round(ms, 3)
        if self.verbose:
            print(f"patolette ======== [{name}] {ms:.1f} ms", flush=True)
        self.t = now

    @contextlib.contextmanager
    def stage(self, name):
        """The block as the span ``name`` (``utils/spans.py``), lapped as
        ``name`` when it ends."""
        with span(name):
            yield
            self.lap(name)


def _gq_bucket_stage(colors, mesh=None):
    """Unweighted global PCA -> bucket sort -> per-bucket moments (K1),
    shifted by the global mean (quirk Q1; reference global.c:407,418).
    With ``mesh``: the moments summed and the projection range reduced over
    the ranks (JAX ``pipeline.py:1400-1416``)."""
    tot = M.total_moments(colors, mesh=mesh)
    mean = M.moments_center(tot)
    axis, _ = eigen3.principal_axis(M.moments_cov(tot))
    proj = M.project(colors, axis)
    buckets = M.bucketize(proj, GQ.BUCKET_COUNT,
                          PM.pmin(mesh, torch.min(proj)),
                          PM.pmax(mesh, torch.max(proj)), mesh=mesh)
    bm = M.segment_moments(colors, buckets, GQ.BUCKET_COUNT, shift=mean,
                           mesh=mesh)
    return buckets, bm


def _lq_stage(colors, weights, buckets, cuts, k0, palette_size,
              batch_splits, mesh=None):
    labels0 = GQ.labels_from_cuts(buckets, cuts)
    labels, count = LQ.lq_quantize(colors, weights, labels0, k0,
                                   palette_size, batch_splits=batch_splits,
                                   mesh=mesh)
    centers, mass = PAL.centers_from_labels(colors, weights, labels,
                                            palette_size, mesh=mesh)
    valid = (torch.arange(palette_size, device=colors.device) < count) & (
        mass > 0.0)
    return labels, count, centers, valid


def _gq_lq_palette(x_lq, w_lq, p, batch_splits, verbose, timer):
    """GQ (device moments + host f64 DP) then LQ on prepared samples."""
    with timer.stage("gq-moments"):
        buckets, bm = _gq_bucket_stage(x_lq)
        bm_np = bm.to(torch.float64).cpu().numpy()
    with timer.stage("gq-dp"):
        cuts = GQ.gq_host(bm_np, p)
        k0 = len(cuts) - 1
        _log(verbose, f"Base cluster count: {k0}")
    with timer.stage("lq"):
        return _lq_stage(x_lq, w_lq, buckets, cuts, k0, p,
                         max(1, int(batch_splits)))


def _gather(channels, idx):
    """Planar channels -> interleaved (M, 3) subsample by index."""
    return torch.stack([ch[idx] for ch in channels], dim=-1).contiguous()


def _fill_palette(pal_srgb, valid, p):
    """(p, 3) sRGB f64 with [-1,-1,-1] rows where ``valid`` is False
    (patolette.c:328); numpy in, numpy out."""
    palette = np.full((p, 3), -1.0)
    palette[valid] = pal_srgb[valid].astype(np.float64)
    return palette


def _finish_palette(palette_work, valid, p, csp):
    """Working-space palette -> sRGB f64 with [-1,-1,-1] fill."""
    return _fill_palette(cs.working_to_srgb(palette_work, csp).cpu().numpy(),
                         valid.cpu().numpy(), p)


def _put(colors, device, non_blocking=False):
    """(N, 3) host pixels -> the same (N, 3) on the device, uint8 as bytes,
    anything else as f32. K10 normalises and de-interleaves them as it
    converts them. ``non_blocking``: the copy is queued on the stream and
    the host goes on (the source is staged before the call returns)."""
    if colors.dtype != np.uint8:
        colors = np.asarray(colors, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(colors)).to(
        device, non_blocking=non_blocking)


def _put_weights(w_host, device, non_blocking=False):
    return None if w_host is None else torch.from_numpy(
        np.ascontiguousarray(w_host, dtype=np.float32)).to(
            device, non_blocking=non_blocking)


def _start_host_copy(t):
    """Start ``t``'s copy to the host without waiting: into pinned memory,
    queued on the current stream behind the work that makes ``t``. Returns
    the handle :func:`_host_copy_done` waits on."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _host_copy_done(copy) -> np.ndarray:
    host, done = copy
    if done is not None:
        done.synchronize()
    return host.numpy()


def _palette_pack(centers, valid, csp):
    """The sRGB palette and its valid flags in one f32 vector, ``[3p sRGB
    | p valid]``, the JAX device programs' pack: one small copy back."""
    return torch.cat([cs.working_to_srgb(centers, csp).reshape(-1),
                      valid.to(torch.float32)])


def _unpack_palette(pack_np, p):
    """A pack (:func:`_palette_pack`) on the host -> the (p, 3) f64 palette
    with the [-1, -1, -1] fill and the (p,) valid flags (the JAX package's
    ``_unpack_palette``)."""
    valid = pack_np[3 * p:4 * p] > 0.5
    return _fill_palette(pack_np[:3 * p].reshape(p, 3), valid, p), valid


def _device_budget(device):
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return int(total * DEVICE_BUDGET_FRACTION) - LQ_GRAPH_BYTES
    return 1 << 62


def quantize(
    width: int,
    height: int,
    colors,
    palette_size: int,
    dither: bool = True,
    palette_only: bool = False,
    color_space: ColorSpace = ColorSpace.ICtCp,
    tile_size: float = 512.0,
    kmeans_niter: int = 32,
    kmeans_max_samples: int = 512**2,
    verbose: bool = False,
    *,
    weights=None,
    lq_max_samples: int = 1 << 18,
    lq_batch_splits: int = 8,
    dither_segment: int = 4096,
    seed: int = 1234,
    mesh=None,
    device=None,
    sync_stages: bool = False,
):
    """Quantize an image to ``palette_size`` colors.

    Signature and return convention of the JAX package's ``quantize``
    (reference pyx:332-466): ``(success, palette, palette_map, message)``
    with ``palette`` a (palette_size, 3) float64 sRGB array ([-1,-1,-1]
    rows for unused slots) and ``palette_map`` an int32 array of length
    width*height (None if ``palette_only``).

    ``device``: where the work runs, ``"cuda"`` by default; with no CUDA
    device the call fails (typed) unless the caller passes ``"cpu"``, which
    runs the kernels' plain versions. ``sync_stages``: wait for the device
    at each stage lap, so ``LAST_STAGE_TIMES`` holds device time (also on
    under ``verbose`` and :func:`set_sync_stages`).

    ``mesh``: a :class:`patolette_tpu_torch.parallel.mesh.Mesh`. Every rank
    of its group calls ``quantize`` with the same arguments and the whole
    image; each works on its own row strip on the mesh's device, and every
    rank returns the same palette and the whole map (``_quantize_sharded``).
    Shapes that do not divide over the ranks run the single-device routes
    on every rank.

    Internal failures return
    ``(False, None, None, "Internal quantization error. [Type: detail]")``.
    """
    try:
        return _quantize_body(
            width, height, colors, palette_size, dither=dither,
            palette_only=palette_only, color_space=color_space,
            tile_size=tile_size, kmeans_niter=kmeans_niter,
            kmeans_max_samples=kmeans_max_samples, verbose=verbose,
            weights=weights, lq_max_samples=lq_max_samples,
            lq_batch_splits=lq_batch_splits, dither_segment=dither_segment,
            seed=seed, mesh=mesh, device=device, sync_stages=sync_stages,
        )
    except Exception as e:  # noqa: BLE001 -- the reference's -1 surface
        return typed_failure(e)


def typed_failure(e):
    """The reference's -1 surface for an internal failure."""
    msg = errors.exit_code_message(errors.ExitCode.BAD_QUANT)
    detail = str(e).strip().splitlines()
    detail = detail[0] if detail else ""
    return False, None, None, f"{msg} [{type(e).__name__}: {detail}]"


def _quantize_body(width, height, colors, palette_size, *, dither,
                   palette_only, color_space, tile_size, kmeans_niter,
                   kmeans_max_samples, verbose, weights, lq_max_samples,
                   lq_batch_splits, dither_segment, seed, mesh, device,
                   sync_stages, local=False):
    """``local``: ``colors`` (and ``weights``) are only this rank's rows of
    the image, and the map returned is theirs (``quantize_distributed``);
    shapes that do not divide over the ranks then fail."""
    colors = np.asarray(colors)
    if colors.ndim != 2 or colors.shape[1] != 3:
        ch = colors.shape[1] if colors.ndim == 2 else colors.ndim
        return False, None, None, errors.BAD_CHANNEL_COUNT.format(ch)
    world = mesh.world if local else 1
    if (width * height) % world or colors.shape[0] * world != width * height:
        return False, None, None, errors.COLOR_MISMATCH
    if tile_size < 0:
        return False, None, None, errors.BAD_TILE_SIZE
    code = errors.validate_dims(width, height, palette_size)
    if code != errors.ExitCode.SUCCESS:
        return False, None, None, errors.exit_code_message(code)

    n = width * height
    p = int(palette_size)
    dither = bool(dither) and not palette_only
    if mesh is not None:
        if not isinstance(mesh, PM.Mesh):
            raise TypeError(f"mesh= takes a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        device = mesh.device
        if local and dither and height % mesh.world:
            raise ValueError(f"a dither needs the height ({height}) to "
                             f"divide over {mesh.world} ranks")
        if n % mesh.world or (dither and height % mesh.world):
            _log(verbose, "mesh given but shapes not divisible; running "
                          "single-device")
            mesh = None
    device = resolve_device(device)
    saliency = weights is None and tile_size > 0
    timer = _StageTimer(verbose, verbose or sync_stages or _SYNC_STAGES,
                        device)
    csp = int(color_space)
    kw = dict(
        palette_only=palette_only, csp=csp, kmeans_niter=int(kmeans_niter),
        kmeans_max_samples=int(kmeans_max_samples), verbose=verbose,
        weights=weights, lq_max_samples=int(lq_max_samples),
        lq_batch_splits=int(lq_batch_splits), seed=int(seed), device=device,
        timer=timer,
    )

    # --- the sampled route (pipeline.py:1003-1024 of the JAX package) ---
    lut_eligible = colors.dtype == np.uint8 and not dither and p <= 65536
    m_pal = n if not lq_max_samples else min(n, int(lq_max_samples))
    if kmeans_niter > 0:
        m_pal = max(m_pal,
                    min(n, KM.subsample_cap(p, int(kmeans_max_samples))))
    if (mesh is None and not saliency and m_pal <= SAMPLE_MAX
            and (palette_only or (lut_eligible and n >= _lut_min_pixels(p)))):
        return _quantize_via_samples(colors, p, **kw)

    geometry = dict(width=int(width), height=int(height), dither=dither,
                    dither_segment=int(dither_segment))
    if mesh is not None:
        return _quantize_sharded(colors, p, mesh, **geometry,
                                 tile_size=float(tile_size), local=local,
                                 **kw)

    # --- the streamed route, in the JAX package's order
    # (pipeline.py:1042-1081): large dithered calls without saliency, then
    # whatever exceeds the device budget ---
    if dither and not saliency and n > STRIP_DITHER_MIN_PIXELS \
            and lq_max_samples \
            and not os.environ.get("PATOLETTE_NO_STRIP_DITHER"):
        return _quantize_streamed(colors, p, **geometry, **kw)
    one_shot = n <= ONE_SHOT_MAX_PIXELS and not os.environ.get(
        "PATOLETTE_NO_ONE_SHOT")
    if one_shot:
        per_pixel = (ONE_SHOT_BYTES_PER_PIXEL_SALIENCY_OR_DITHER
                     if saliency or dither else ONE_SHOT_BYTES_PER_PIXEL)
    else:
        per_pixel = (BYTES_PER_PIXEL_SALIENCY_OR_DITHER
                     if saliency or dither else BYTES_PER_PIXEL)
    if n * per_pixel > _device_budget(device):
        if saliency:
            raise RuntimeError(
                f"{n} pixels exceed the device budget for saliency "
                "weighting; pass tile_size=0 or explicit weights="
            )
        if not lq_max_samples:
            raise RuntimeError(
                f"{n} pixels exceed the device budget for a full-data "
                "palette search; set lq_max_samples"
            )
        return _quantize_streamed(colors, p, **geometry, **kw)

    # --- the opt-in full-image fused LUT route (pipeline.py:1083-1103):
    # uint8 undithered calls of at most 256 colours off the sampled route
    # (saliency or explicit weights), within the device budget ---
    if (not palette_only and lut_eligible and p <= 256
            and n >= _lut_min_pixels(p)
            and _image_lut_bytes(n) <= _device_budget(device)
            and os.environ.get("PATOLETTE_FUSED_IMAGE_LUT") == "1"
            and not os.environ.get("PATOLETTE_NO_FUSED_LUT")):
        return _quantize_image_fused_lut(
            colors, p, width=int(width), height=int(height),
            tile_size=float(tile_size), **kw)

    # --- the one-shot route (pipeline.py:1105-1117), else the resident
    # route, with the JAX package's net for a device OOM (pipeline.py:
    # 1119-1161): the footprint above is a measurement of other calls, not
    # of this one, so a call that still runs out of device memory retries
    # streamed where a streamed equivalent exists ---
    try:
        return (_quantize_one_shot if one_shot else _quantize_resident)(
            colors, p, **geometry,
            tile_size=float(tile_size) if saliency else 0.0, **kw)
    except RuntimeError as e:  # torch.cuda.OutOfMemoryError is one
        oom = (isinstance(e, torch.cuda.OutOfMemoryError)
               or "out of memory" in str(e))
        if not (oom and not saliency and lq_max_samples):
            raise
        # the traceback's frames hold the failed call's device tensors;
        # drop them before the retry needs the memory
        traceback.clear_frames(e.__traceback__)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _log(verbose, "Device out of memory on the "
                  f"{'one-shot' if one_shot else 'resident'} route; "
                  "retrying streamed")
    return _quantize_streamed(colors, p, **geometry, **kw)


def _draw_palette_samples(colors, n, w_host, rng, p, lq_max_samples,
                          kmeans_niter, kmeans_max_samples, device):
    """Host-side LQ + KMeans sample draws, uploaded without waiting.

    The JAX package's ``_draw_palette_samples`` (pipeline.py:243-290) draw
    for draw: the LQ draw, then a KMeans draw when n exceeds the KMeans cap
    unless the LQ sample can stand in for it (S11: unweighted, and the LQ
    sample already has the cap's size), weights gathered by the same
    indices. Returns ``(x_lq, w_lq, x_km, w_km)``: (M, 3) sRGB samples (raw
    uint8 or f32) and (M,) f32 weights on the device, ``x_km`` None under
    S11.
    """
    if lq_max_samples and n > lq_max_samples:
        idx = rng.integers(0, n, size=int(lq_max_samples))
        sub, w_lq_h = colors[idx], None if w_host is None else w_host[idx]
    else:
        sub, w_lq_h = colors, w_host

    sub_km_h = w_km_h = None
    if kmeans_niter > 0:
        cap = KM.subsample_cap(p, int(kmeans_max_samples))
        if n > cap and not (len(sub) == cap and w_host is None):
            idx2 = rng.integers(0, n, size=cap)
            sub_km_h = colors[idx2]
            w_km_h = None if w_host is None else w_host[idx2]
        elif n <= cap and sub is not colors:
            sub_km_h, w_km_h = colors, w_host
        # else: KMeans reuses the LQ sample (S11)

    def up(x):
        return None if x is None else _put(x, device, non_blocking=True)

    return (up(sub), _put_weights(w_lq_h, device, non_blocking=True),
            up(sub_km_h), _put_weights(w_km_h, device, non_blocking=True))


def _upload_samples(colors, p, *, weights, seed, lq_max_samples,
                    kmeans_niter, kmeans_max_samples, device):
    """The sampled and streamed routes' draws from
    ``np.random.default_rng(seed)``, on the device."""
    w_host = (None if weights is None
              else np.asarray(weights, np.float32).reshape(-1))
    return _draw_palette_samples(
        colors, colors.shape[0], w_host, np.random.default_rng(seed), p,
        lq_max_samples, kmeans_niter, kmeans_max_samples, device)


def _palette_program(x_lq, w_lq, x_km, w_km, *, p, csp, kmeans_niter,
                     kmeans_max_samples, seed, lq_batch_splits):
    """The palette core on working-space samples, no draw of its own
    (``lq_max_samples`` 0; ``x_km`` None: KMeans runs on ``x_lq``, which
    then holds at most the KMeans cap, S11), then the pack. Returns
    ``(centers, valid, pack)`` on the device; nothing is read back."""
    centers, valid = _palette_core(
        x_lq, w_lq, p, kmeans_niter, kmeans_max_samples, seed, None,
        max(1, int(lq_batch_splits)), 0, x_km=x_km, w_km=w_km)
    return centers, valid, _palette_pack(centers, valid, csp)


def _sample_palette_program(x_lq, w_lq, x_km, w_km, *, csp, **kw):
    """The JAX package's ``_sample_palette_program`` (pipeline.py:302-333):
    the host-drawn sRGB samples to the working space (K10), then
    :func:`_palette_program`: K1, K11, K2 and K4 with no host read."""
    def work(x):
        return None if x is None else cs.srgb_to_working(x, csp)

    return _palette_program(work(x_lq), w_lq, work(x_km), w_km, csp=csp,
                            **kw)


def _lut_program(centers, valid, csp):
    """The u8 table of a palette of at most 256 entries over the cached
    grid (K5) and its v2 encoding (K6). Returns ``(table, enc)``."""
    table = LUT.build_lut_device(centers, valid, csp, torch.uint8)
    return table, rle_encode_u8_v2(table)


def _sample_lut_program(x_lq, w_lq, x_km, w_km, *, csp, **kw):
    """The JAX package's ``_sample_lut_program`` (pipeline.py:340-373):
    :func:`_sample_palette_program`, then :func:`_lut_program`. Returns
    ``(pack, table, enc)``; nothing is read back."""
    centers, valid, pack = _sample_palette_program(x_lq, w_lq, x_km, w_km,
                                                   csp=csp, **kw)
    return (pack, *_lut_program(centers, valid, csp))


def _pull_lut_program(colors, p, pack, table, enc, timer):
    """The two pulls of a fused LUT program and the host map (JAX
    ``pipeline.py:438-449``): the pack's copy starts first, then the v2
    words come back; on v2's overflow the table goes straight to v1 or a
    raw copy. Laps ``lut-pull`` and ``lut-map-host``."""
    with timer.stage("lut-pull"):
        pack = _start_host_copy(pack)
        lut = LUT.pull_encoded_v2(enc)
        if lut is None:
            lut = LUT.pull_lut(table, try_v2=False)
    with timer.stage("lut-map-host"):
        palette_map = LUT.lut_map_host(colors, lut)
    palette, _ = _unpack_palette(_host_copy_done(pack), p)
    return True, palette, palette_map, errors.exit_code_message(
        errors.ExitCode.SUCCESS
    )


def _quantize_via_samples_fused(colors, p, *, csp, kmeans_niter,
                                kmeans_max_samples, verbose, weights,
                                lq_max_samples, lq_batch_splits, seed,
                                device, timer):
    """The fused sampled LUT route (the JAX package's
    ``_quantize_via_samples_fused``, pipeline.py:452-493): the samples go
    up, :func:`_sample_lut_program` runs, two pulls come back. Laps
    ``sample-in``, ``palette+lut-build`` (the host's enqueue unless
    synced), ``lut-pull``, ``lut-map-host``."""
    with timer.stage("sample-in"):
        samples = _upload_samples(
            colors, p, weights=weights, seed=seed,
            lq_max_samples=lq_max_samples, kmeans_niter=kmeans_niter,
            kmeans_max_samples=kmeans_max_samples, device=device)
    _log(verbose, "Palette + LUT (fused device program)")
    with timer.stage("palette+lut-build"):
        pack, table, enc = _sample_lut_program(
            *samples, p=p, csp=csp, kmeans_niter=kmeans_niter,
            kmeans_max_samples=kmeans_max_samples, seed=seed,
            lq_batch_splits=lq_batch_splits)
        del samples
    return _pull_lut_program(colors, p, pack, table, enc, timer)


def _sample_palette(colors, p, *, csp, kmeans_niter, kmeans_max_samples,
                    verbose, weights, lq_max_samples, lq_batch_splits, seed,
                    device, timer):
    """The staged palette search on the host-drawn samples: GQ with its
    DP on the host in f64, LQ, KMeans. Returns the (p, 3) working-space
    centres and their (p,) valid flags on the device."""
    with timer.stage("sample-in"):
        x_lq, w_lq, x_km, w_km = _upload_samples(
            colors, p, weights=weights, seed=seed,
            lq_max_samples=lq_max_samples, kmeans_niter=kmeans_niter,
            kmeans_max_samples=kmeans_max_samples, device=device)
        x_lq = cs.srgb_to_working(x_lq, csp)

    _log(verbose, "Palette generation")
    _, _, centers, valid = _gq_lq_palette(
        x_lq, w_lq, p, lq_batch_splits, verbose, timer
    )

    if kmeans_niter > 0:
        _log(verbose, "KMeans refinement")
        with timer.stage("kmeans"):
            if x_km is None:  # S11: reuse the LQ sample
                x_km, w_km = x_lq, w_lq
            else:
                x_km = cs.srgb_to_working(x_km, csp)
            centers = KM.lloyd_iterations(x_km, w_km, centers, valid,
                                          kmeans_niter)
    return centers, valid


def _quantize_via_samples(colors, p, *, palette_only, csp, kmeans_niter,
                          kmeans_max_samples, verbose, weights,
                          lq_max_samples, lq_batch_splits, seed, device,
                          timer):
    """Sample-upload + LUT route: device work independent of N.

    The palette search needs only its deterministic samples (lq_max_samples
    for GQ/LQ; the reference's own KMeans cap, refine.c:87), so only those
    go to the device. The palette map of a uint8 image factors through the
    2^24 possible colours (``ops/lut.py``): K5 builds one table, it comes
    back run-length encoded (K6 and the host decode), and the host
    resolves every pixel.

    As in the JAX package (pipeline.py:551-561), a mapped call of at most
    256 colours runs the fused program (:func:`_quantize_via_samples_fused`)
    unless ``PATOLETTE_NO_FUSED_LUT`` is set; the rest (``palette_only``,
    u16 tables) run staged: GQ with the host f64 DP, LQ, KMeans, then
    ``LUT.pull_lut`` (the JAX package's pipeline.py:563-614).
    """
    kw = dict(csp=csp, kmeans_niter=kmeans_niter,
              kmeans_max_samples=kmeans_max_samples, verbose=verbose,
              weights=weights, lq_max_samples=lq_max_samples,
              lq_batch_splits=lq_batch_splits, seed=seed, device=device,
              timer=timer)
    if (not palette_only and p <= 256
            and not os.environ.get("PATOLETTE_NO_FUSED_LUT")):
        return _quantize_via_samples_fused(colors, p, **kw)

    centers, valid = _sample_palette(colors, p, **kw)
    palette_map = None
    if not palette_only:
        _log(verbose, "NN mapping (24-bit LUT)")
        with timer.stage("lut-build"):
            table = LUT.build_lut_device(centers, valid, csp,
                                         LUT.lut_dtype(p))
        with timer.stage("lut-build+pull"):
            table = LUT.pull_lut(table)
        with timer.stage("lut-map-host"):
            palette_map = LUT.lut_map_host(colors, table)

    palette = _finish_palette(centers, valid, p, csp)
    return True, palette, palette_map, errors.exit_code_message(
        errors.ExitCode.SUCCESS
    )


def _map_strip(strip, centers, valid, width, rows, csp, dither, segment):
    """(rows * width,) int32 palette map of one (rows * width, 3) strip on
    the device, by the JAX streamed route's chain for its input type
    (pipeline.py:704-752), each chain one K10 pass: a dithered uint8 strip
    goes from sRGB straight to linear Rec2020 (the packed feed), a
    dithered float strip sRGB -> working -> linear Rec2020 (the planar
    feed), the undithered map sRGB -> working -> ICtCp, then K3."""
    if dither and strip.dtype == torch.uint8:
        return DITH.riemersma_dither_packed_u8(
            strip, centers, valid, width, rows, csp, segment=segment)
    if dither:
        return DITH.riemersma_dither_rec2020(
            color_convert(strip, csp, "rec2020"), centers, valid, width,
            rows, csp, segment=segment)
    return assign_planar(color_convert(strip, csp, "ictcp"),
                         cs.working_to_ictcp(centers, csp), valid)


def _quantize_streamed(colors, p, *, width, height, dither, dither_segment,
                       palette_only, csp, kmeans_niter, kmeans_max_samples,
                       verbose, weights, lq_max_samples, lq_batch_splits,
                       seed, device, timer):
    """The palette from samples, then the map per row strip with one strip
    on the device at a time (the JAX package's ``_quantize_streamed``,
    pipeline.py:657-766). The palette is :func:`_sample_palette_program`
    on the host-drawn samples (lap ``palette (device)``), its pack copied
    back behind it. Each strip of ``_stream_strip_pixels(n) // width``
    rows goes up as it is, is mapped, and its map comes back into the host
    array before the next one goes up, so device memory does not grow with
    N. Seams: the undithered map is per pixel and exact; the dither runs
    each strip along its own curve with a fresh error queue.
    """
    n = width * height
    _log(verbose, f"Streamed route: {n / 1e6:.1f} MP")
    with timer.stage("sample-in"):
        samples = _upload_samples(
            colors, p, weights=weights, seed=seed,
            lq_max_samples=lq_max_samples, kmeans_niter=kmeans_niter,
            kmeans_max_samples=kmeans_max_samples, device=device)
    with timer.stage("palette (device)"):
        centers, valid, pack = _sample_palette_program(
            *samples, p=p, csp=csp, kmeans_niter=kmeans_niter,
            kmeans_max_samples=kmeans_max_samples, seed=seed,
            lq_batch_splits=lq_batch_splits)
        del samples
        pack = _start_host_copy(pack)

    palette_map = None
    if not palette_only:
        palette_map = np.empty((n,), np.int32)
        rows = max(1, _stream_strip_pixels(n) // max(1, width))
        mode = "dither" if dither else "nn-map"
        _log(verbose, f"Streamed {mode}: strips of {rows} rows")
        for r0 in range(0, height, rows):
            r1 = min(height, r0 + rows)
            with timer.stage("strip-in"):
                strip = _put(colors[r0 * width:r1 * width], device)
            with timer.stage(mode):
                pm = _map_strip(strip, centers, valid, width, r1 - r0, csp,
                                dither, dither_segment)
                del strip
                torch.from_numpy(
                    palette_map[r0 * width:r1 * width]).copy_(pm)
                del pm

    with timer.stage("palette-out"):
        palette, _ = _unpack_palette(_host_copy_done(pack), p)
    return True, palette, palette_map, errors.exit_code_message(
        errors.ExitCode.SUCCESS
    )


def _working_image(colors, weights, width, height, tile_size, csp, device,
                   verbose, timer):
    """Upload, weights (explicit > MBD saliency when ``tile_size > 0`` >
    none) and the working-space planes on the device: the front of the
    resident and one-shot routes. Returns ``(planes, weights or None)``;
    saliency gives None when a side is <= 3."""
    with timer.stage("stage-in"):
        x = _put(colors, device)
        w = None
        if weights is not None:
            w = _put_weights(np.asarray(weights).reshape(-1), device)
    if tile_size <= 0:
        return color_convert(x, csp, "working"), w
    _log(verbose, "Generating saliency map")
    with timer.stage("saliency"):
        xp_srgb = color_convert(x, 0, "working")
        del x
        w = SAL.get_weights_planar(xp_srgb, height, width, tile_size)
    return tuple(cs.srgb_to_working(xp_srgb, csp)), w


def _quantize_resident(colors, p, *, width, height, palette_only, dither,
                       dither_segment, tile_size, csp, kmeans_niter,
                       kmeans_max_samples, verbose, weights, lq_max_samples,
                       lq_batch_splits, seed, device, timer):
    """The resident route: planar image on the device end to end."""
    n = width * height
    xp_work, w_full = _working_image(colors, weights, width, height,
                                     tile_size, csp, device, verbose, timer)
    _log(verbose, "Palette generation")

    rng = np.random.default_rng(seed)
    with timer.stage("to-working+sample"):
        if lq_max_samples and n > lq_max_samples:
            idx = torch.from_numpy(
                rng.integers(0, n, size=lq_max_samples, dtype=np.int32)
            ).to(device).long()
            x_lq = _gather(xp_work, idx)
            w_lq = None if w_full is None else w_full[idx]
        else:
            x_lq = torch.stack(xp_work, dim=-1).contiguous()
            w_lq = w_full

    _, _, centers, valid = _gq_lq_palette(
        x_lq, w_lq, p, lq_batch_splits, verbose, timer
    )

    if kmeans_niter > 0:
        _log(verbose, "KMeans refinement")
        with timer.stage("kmeans"):
            cap = KM.subsample_cap(p, kmeans_max_samples)
            if n > cap:
                idx = torch.from_numpy(
                    rng.integers(0, n, size=cap, dtype=np.int32)
                ).to(device).long()
                samples = _gather(xp_work, idx)
                w_km = None if w_full is None else w_full[idx]
            else:
                samples = torch.stack(xp_work, dim=-1).contiguous()
                w_km = w_full
            centers = KM.lloyd_iterations(samples, w_km, centers, valid,
                                          kmeans_niter)

    palette_map = None
    if dither:
        _log(verbose, "Dithering")
        with timer.stage("dither"):
            palette_map = DITH.riemersma_dither_planar(
                xp_work, centers, valid, width, height, csp,
                segment=dither_segment,
            ).cpu().numpy()
    elif not palette_only:
        _log(verbose, "NN mapping")
        with timer.stage("nn-map"):
            xi = cs.working_to_ictcp(xp_work, csp)
            pi = cs.working_to_ictcp(centers, csp)
            palette_map = assign_planar(xi, pi, valid).cpu().numpy()

    with timer.stage("palette-out"):
        palette = _finish_palette(centers, valid, p, csp)
    return True, palette, palette_map, errors.exit_code_message(
        errors.ExitCode.SUCCESS
    )


def _subsample_device(x, weights, cap: int, generator):
    """With-replacement draw of ``cap`` pixels on the device (JAX
    ``pipeline.py:1282-1301``). ``x``: interleaved (N, 3) or a planar
    3-tuple of (N,); returns an interleaved (min(N, cap), 3) sample and its
    weights. ``cap`` 0 or N <= cap: all of ``x``."""
    if not isinstance(x, (tuple, list)):
        return KM.subsample(x, weights, cap, generator)
    idx = KM.draw_indices(x[0].shape[0], cap, generator, x[0].device)
    if idx is None:
        return torch.stack(tuple(x), dim=-1).contiguous(), weights
    return _gather(x, idx), None if weights is None else weights[idx]


def _palette_core(x, weights, palette_size, kmeans_niter, kmeans_max_samples,
                  seed, mesh, lq_batch_splits, lq_max_samples, x_km=None,
                  w_km=None):
    """GQ (K11) -> LQ -> KMeans on working-space colours with no host read
    (JAX ``pipeline.py:1353-1397``). ``x``: interleaved (N, 3) or a planar
    3-tuple. The LQ sample and the KMeans sample are drawn on the device
    from generators seeded from ``(seed, 0)`` and ``(seed, 1)``, with
    ``mesh`` from ``(seed, rank, 0)`` and ``(seed, rank, 1)``, each rank
    drawing its share of the caps from its own pixels; ``x_km``/``w_km``
    replace the KMeans draw. Returns ``(centers, valid)`` on the device."""
    dev = (x[0] if isinstance(x, (tuple, list)) else x).device
    p = int(palette_size)
    key = (int(seed),) if mesh is None else (int(seed), mesh.rank)
    x_lq, w_lq = _subsample_device(
        x, weights, PM.per_rank_cap(lq_max_samples, mesh),
        KM.device_generator(dev, *key, 0))
    buckets, bm = _gq_bucket_stage(x_lq, mesh)
    cuts, k0 = GQ.gq_device(bm, p)
    _, _, centers, valid = _lq_stage(x_lq, w_lq, buckets, cuts, k0, p,
                                     max(1, int(lq_batch_splits)), mesh)
    if kmeans_niter > 0:
        if x_km is None:
            cap = PM.per_rank_cap(
                KM.subsample_cap(p, int(kmeans_max_samples)), mesh)
            x_km, w_km = _subsample_device(
                x, weights, cap, KM.device_generator(dev, *key, 1))
        centers = KM.lloyd_iterations(x_km, w_km, centers, valid,
                                      int(kmeans_niter), mesh=mesh)
    return centers, valid


def palette_pipeline_device(colors, weights, palette_size: int,
                            color_space: int = 2, kmeans_niter: int = 0,
                            kmeans_max_samples: int = 512**2,
                            seed: int = 1234, mesh=None,
                            lq_batch_splits: int = 8,
                            lq_max_samples: int = 0, with_map: bool = True,
                            device=None):
    """Palette generation with no host read, the JAX package's
    ``palette_pipeline_device`` (``pipeline.py:1304-1350``).

    ``colors``: interleaved (N, 3) or a planar 3-tuple of (N,), sRGB f32 in
    [0, 1] or raw uint8 (numpy arrays or tensors); ``weights``: (N,) or
    None. The work runs on ``device`` (``cuda`` by default), with ``mesh``
    on the mesh's device: then ``colors`` are this rank's pixels, every
    pixel sum is summed over the ranks, the DP and the greedy control run
    on every rank on the reduced sums, and each rank draws its share of
    the sample caps from ``(seed, rank)`` (``mesh=`` takes the place of the
    JAX package's ``axis_name``). ``lq_max_samples`` > 0 caps the GQ/LQ
    search; KMeans keeps its own cap ``max(kmeans_max_samples, 256^2)``.

    Numpy input goes to ``device`` (the mesh's with ``mesh``); tensors stay
    where they are (``utils/device.py``). Returns ``(palette_working (P,
    3), valid (P,), palette_map (N,))`` on that device, the map for these
    pixels; ``with_map=False`` returns ``(palette_working, valid)``.
    """
    dev = call_device(colors, mesh.device if mesh is not None else device)
    csp = int(color_space)
    if isinstance(colors, (tuple, list)):
        x = tuple(on_device(ch, dev) for ch in colors)
        if x[0].dtype == torch.uint8:  # (N, 3) bytes: K10's byte path
            x = color_convert(torch.stack(x, dim=1), csp, "working")
        else:
            x = tuple(cs.srgb_to_working(x, csp))
        planar = x
    else:
        x = cs.srgb_to_working(on_device(colors, dev), csp)
        planar = (x[:, 0], x[:, 1], x[:, 2])
    w = None if weights is None else on_device(weights, dev).reshape(-1)

    centers, valid = _palette_core(
        x, w, palette_size, kmeans_niter, kmeans_max_samples, seed, mesh,
        lq_batch_splits, lq_max_samples)
    if not with_map:
        return centers, valid
    pmap = assign_planar(cs.working_to_ictcp(planar, csp),
                         cs.working_to_ictcp(centers, csp), valid)
    return centers, valid, pmap


def _quantize_one_shot(colors, p, *, width, height, palette_only, dither,
                       dither_segment, tile_size, csp, kmeans_niter,
                       kmeans_max_samples, verbose, weights, lq_max_samples,
                       lq_batch_splits, seed, device, timer):
    """The one-shot route (the JAX package's ``_one_shot_program`` and its
    unpacking, ``pipeline.py:786-887``): upload, saliency when
    ``tile_size > 0``, K10 to the working space,
    the palette core, the dither or the direct map, the sRGB palette; no
    host read until the palette and the map come back together at the
    end. Laps: ``stage-in``, ``saliency``, ``palette``, ``dither`` or
    ``nn-map`` (the host's enqueue unless synced), then ``one-shot``
    (the wait for the device and the read back)."""
    _log(verbose, "One-shot device pipeline")
    xp_work, w = _working_image(colors, weights, width, height, tile_size,
                                csp, device, verbose, timer)
    _log(verbose, "Palette generation")
    with timer.stage("palette"):
        centers, valid = _palette_core(
            xp_work, w, p, kmeans_niter, kmeans_max_samples, seed, None,
            lq_batch_splits, lq_max_samples)

    pmap = None
    if dither:
        _log(verbose, "Dithering")
        with timer.stage("dither"):
            pmap = DITH.riemersma_dither_planar(
                xp_work, centers, valid, width, height, csp,
                segment=dither_segment)
    elif not palette_only:
        _log(verbose, "NN mapping")
        with timer.stage("nn-map"):
            pmap = assign_planar(cs.working_to_ictcp(xp_work, csp),
                                 cs.working_to_ictcp(centers, csp), valid)
    del xp_work, w

    # the one wait: every result copied back, then the stream synced
    with timer.stage("one-shot"):
        outs = [t.to("cpu", non_blocking=True) for t in
                (cs.working_to_srgb(centers, csp), valid)
                + (() if pmap is None else (pmap,))]
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        palette = _fill_palette(outs[0].numpy(), outs[1].numpy(), p)
        palette_map = None if pmap is None else outs[2].numpy()
    return True, palette, palette_map, errors.exit_code_message(
        errors.ExitCode.SUCCESS
    )


def _image_lut_program(x, w, *, width, height, p, csp, tile_size,
                       kmeans_niter, kmeans_max_samples, seed,
                       lq_max_samples, lq_batch_splits):
    """The JAX package's ``_image_lut_program`` (pipeline.py:380-411) on
    the uploaded (N, 3) image ``x`` (uint8 bytes): saliency weights (K9)
    when ``w`` is None and ``tile_size > 0``, K10 to the working space, the
    palette core with its device draws, the pack, then
    :func:`_lut_program`. The same front as the one-shot route
    (:func:`_working_image`), so the palette is that route's. Returns
    ``(pack, table, enc)``; nothing is read back."""
    if w is None and tile_size > 0:
        xp_srgb = color_convert(x, 0, "working")
        w = SAL.get_weights_planar(xp_srgb, height, width, tile_size)
        xw = tuple(cs.srgb_to_working(xp_srgb, csp))
        del xp_srgb
    else:
        xw = color_convert(x, csp, "working")
    centers, valid = _palette_core(
        xw, w, p, kmeans_niter, kmeans_max_samples, seed, None,
        max(1, int(lq_batch_splits)), lq_max_samples)
    del xw, w
    return (_palette_pack(centers, valid, csp),
            *_lut_program(centers, valid, csp))


def _image_lut_bytes(n: int) -> int:
    """The fused image LUT route's device footprint model: the measured
    bytes a pixel and the grid, table and encoding, whatever N."""
    return n * IMAGE_LUT_BYTES_PER_PIXEL + IMAGE_LUT_FIXED_BYTES


def _quantize_image_fused_lut(colors, p, *, width, height, tile_size,
                              palette_only, csp, kmeans_niter,
                              kmeans_max_samples, verbose, weights,
                              lq_max_samples, lq_batch_splits, seed, device,
                              timer):
    """The opt-in full-image fused LUT route (the JAX package's
    ``_quantize_image_fused_lut``, pipeline.py:414-449), for mapped
    (``palette_only`` False), undithered calls: the image goes up (lap
    ``stage-in``), :func:`_image_lut_program` runs (lap
    ``saliency+palette+lut-build``), then the pulls and the host map of the
    sampled fused route."""
    with timer.stage("stage-in"):
        x = _put(colors, device)
        w = (None if weights is None else
             _put_weights(np.asarray(weights).reshape(-1), device))
    _log(verbose, "Saliency + palette + LUT (fused device program)")
    with timer.stage("saliency+palette+lut-build"):
        pack, table, enc = _image_lut_program(
            x, w, width=width, height=height, p=p, csp=csp,
            tile_size=tile_size if weights is None else 0.0,
            kmeans_niter=kmeans_niter,
            kmeans_max_samples=kmeans_max_samples, seed=seed,
            lq_max_samples=lq_max_samples, lq_batch_splits=lq_batch_splits)
        del x, w
    return _pull_lut_program(colors, p, pack, table, enc, timer)


def _gather_rows(mesh, rows):
    """Every rank's (n_local, 3) rows in rank order, on every host (exact:
    uint8 travels as int32)."""
    kind = np.int32 if rows.dtype == np.uint8 else np.float32
    full = PM.gather(mesh, torch.from_numpy(np.ascontiguousarray(
        rows, dtype=kind))).numpy()
    return full.astype(rows.dtype if rows.dtype == np.uint8 else np.float32)


def _quantize_sharded(colors, p, mesh, *, width, height, dither,
                      dither_segment, palette_only, csp, tile_size,
                      kmeans_niter, kmeans_max_samples, verbose, weights,
                      lq_max_samples, lq_batch_splits, seed, device, timer,
                      local=False):
    """The multi-device route (the JAX package's ``_quantize_sharded``,
    pipeline.py:1447-1555), one process a rank. ``colors``/``weights``:
    the whole image, or with ``local`` only this rank's rows; the map
    returned is the whole image's, or with ``local`` this rank's rows.

    Stages, with the JAX package's laps: ``stage-in`` (the rank's row
    strip goes up as it is, uint8 as bytes), ``saliency`` (per strip; the
    whole image's below a strip height of 4), ``palette (sharded)``
    (``PM.quantize_palette_sharded``: the palette core on the strip with
    every sum reduced over the ranks, each rank drawing its share of the
    caps on the device from ``(seed, rank)``, K11 on the reduced moments;
    with the direct map when neither the dither nor the 24-bit table
    maps), ``dither`` or ``nn-map``. ``lq_batch_splits`` is the factory's,
    as in the JAX package.
    """
    n = width * height
    lo, hi = PM.shard_range(n, mesh)
    rows = colors if local else colors[lo:hi]
    w_host = (None if weights is None
              else np.asarray(weights, np.float32).reshape(-1))
    if w_host is not None and not local:
        w_host = w_host[lo:hi]
    saliency = weights is None and tile_size > 0
    strip_h = height // mesh.world if height % mesh.world == 0 else 0
    lut_route = (not palette_only and not dither
                 and colors.dtype == np.uint8 and p <= 256
                 and n >= _lut_min_pixels(p)
                 and LUT.LUT_SIZE % mesh.world == 0)
    with timer.stage("stage-in"):
        chans = _put(rows, device).unbind(1)
        w_dev = _put_weights(w_host, device)

    if saliency:
        with timer.stage("saliency"):
            if strip_h > 3:
                _log(verbose, "Generating saliency map (per-strip)")
                w_dev = PM.saliency_sharded(mesh, width, strip_h, tile_size,
                                            n)(chans)
            elif height > 3 and width > 3:
                _log(verbose, "Generating saliency map (replicated)")
                full = _gather_rows(mesh, rows) if local else colors
                w_all = SAL.get_weights_planar(
                    color_convert(_put(full, device), 0, "working"), height,
                    width, tile_size)
                w_dev = w_all[lo:hi].contiguous()

    _log(verbose, "Palette generation (sharded)")
    with_map = not palette_only and not dither and not lut_route
    with timer.stage("palette (sharded)"):
        out = PM.quantize_palette_sharded(
            mesh, p, color_space=csp, kmeans_niter=kmeans_niter,
            kmeans_max_samples=kmeans_max_samples, seed=seed,
            lq_max_samples=lq_max_samples, planar=True, with_map=with_map,
        )(chans, w_dev)
        centers, valid = out[0], out[1]
        del w_dev

    palette_map = None
    if not palette_only:
        with timer.stage("dither" if dither else "nn-map"):
            if lut_route:
                _log(verbose, "NN mapping (sharded 24-bit LUT)")
                enc, lut_slice = LUT.build_lut_enc_sharded(mesh, centers,
                                                           valid, csp)
                table = LUT.pull_lut_sharded(mesh, enc, lut_slice)
                palette_map = LUT.lut_map_host(colors, table)
            else:
                if dither:
                    _log(verbose, "Dithering (per-strip)")
                    pm = PM.dither_sharded(mesh, width, height, csp,
                                           dither_segment, planar=True)(
                        chans, centers, valid)
                else:
                    pm = out[2]
                del out, chans
                palette_map = (pm if local
                               else PM.gather(mesh, pm)).cpu().numpy()

    palette = _finish_palette(centers, valid, p, csp)
    return True, palette, palette_map, errors.exit_code_message(
        errors.ExitCode.SUCCESS
    )


def quantize_options(width, height, colors, palette_size, options=None,
                     **overrides):
    """Options-object variant of :func:`quantize`; keyword ``overrides``
    (including ``device``) take precedence."""
    opts = options or QuantizeOptions()
    kw = dict(
        dither=opts.dither,
        palette_only=opts.palette_only,
        color_space=opts.color_space,
        tile_size=opts.tile_size,
        kmeans_niter=opts.kmeans_niter,
        kmeans_max_samples=opts.kmeans_max_samples,
        verbose=opts.verbose,
        lq_max_samples=opts.lq_max_samples,
        lq_batch_splits=opts.lq_batch_splits,
        dither_segment=opts.dither_segment,
        seed=opts.seed,
    )
    kw.update(overrides)
    return quantize(width, height, colors, palette_size, **kw)
