"""Quantization pipeline: the public ``quantize`` API of the port.

Two routes, chosen as the JAX package's ``_quantize_body`` chooses them:

* **Sampled** (``_quantize_via_samples``, the JAX staged variant): uint8
  undithered images without saliency of at least 4 MP, and every
  ``palette_only`` call without saliency. Only the host-drawn palette
  samples go to the device (``_draw_palette_samples``, the JAX package's
  exact draws including the S11 reuse); GQ (K1 moments + host f64 DP) ->
  LQ (K2 with K1) -> KMeans (K4) run on them; the map is K5's 24-bit table
  over the ICtCp grid, pulled raw and resolved on the host
  (``ops/lut.py``). Nothing of size N is on the device, so the device
  budget does not bound these calls.
* **Resident** (``_quantize_resident``, modelled on
  ``_quantize_full_upload``): sRGB -> weights (explicit, else MBD saliency
  with K9 when ``tile_size > 0``) -> working space -> LQ sample draw -> GQ
  -> LQ -> centres (K1) -> KMeans (K4) -> Riemersma dither (K7 curve
  order, K8 scan) or the ICtCp direct map (K3) -> sRGB palette with
  [-1, -1, -1] fill. The image stays on the device as three planar f32
  channels. The JAX package maps uint8 undithered images of at least 4 MP
  on this route through its 24-bit table, to spare the index download over
  its host link; the table equals the direct map, so the port keeps K3.

Every sample draw is on the host from ``np.random.default_rng(seed)``. The
resident route's LQ draw is the JAX package's exact draw; its KMeans draw
follows from the same ``rng`` where the JAX package draws with
``jax.random`` (README divergence T1).

Not in this slice (each returns a typed failure that names it): ``mesh=``
and resident images beyond the device budget. Above 4 MP without saliency
the JAX package dithers per row strip; this route dithers the whole image
along one curve (README divergence T2).
"""

from __future__ import annotations

import time

import numpy as np
import torch

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
from patolette_tpu_torch.utils import errors
from patolette_tpu_torch.utils.config import ColorSpace, QuantizeOptions

# Per-stage wall times (ms) of the most recent quantize() call.
LAST_STAGE_TIMES: dict[str, float] = {}

# Peak device bytes per pixel of one call (torch.cuda.max_memory_allocated
# over a 3840x2160 call on an H100, chip_smoke.py's e2e phases), rounded
# up: 80.3 for the direct map (sRGB and working planes, the ICtCp copy, the
# map, the colour transforms' f64 power transients); 102.1 with saliency
# and dither (the MBD's l, u, d and the Lab and prior planes; the linear
# Rec2020 planes, the curve keys, their sort and the permutation).
BYTES_PER_PIXEL = 84
BYTES_PER_PIXEL_SALIENCY_OR_DITHER = 104
DEVICE_BUDGET_FRACTION = 0.8

# The JAX package's thresholds of the sampled route (pipeline.py:210-217).
# They stay its values: the route decides which pixels KMeans sees (S11),
# so another threshold would give another palette, not only another speed.
LUT_MIN_PIXELS = 1 << 22
SAMPLE_MAX = 1 << 22


def _lut_min_pixels(palette_size: int) -> int:
    if palette_size <= 256:
        return LUT_MIN_PIXELS
    return LUT.LUT_SIZE * LUT.lut_dtype(palette_size).itemsize


def _log(verbose, msg):
    if verbose:
        print(f"patolette ======== {msg}", flush=True)


class _StageTimer:
    """Per-stage wall clock into ``LAST_STAGE_TIMES``. With ``sync`` (on
    under verbose) each lap first waits for the device, so a lap holds its
    own device time; otherwise laps time the host's enqueue."""

    def __init__(self, verbose, sync, device):
        self.verbose = verbose
        self.sync = sync and device.type == "cuda"
        self.device = device
        self.t = time.perf_counter()
        self.laps: dict[str, float] = {}
        global LAST_STAGE_TIMES
        LAST_STAGE_TIMES = self.laps

    def lap(self, name):
        if self.sync:
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        ms = 1e3 * (now - self.t)
        self.laps[name] = self.laps.get(name, 0.0) + round(ms, 3)
        if self.verbose:
            print(f"patolette ======== [{name}] {ms:.1f} ms", flush=True)
        self.t = now


def _resolve_device(device):
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device not available; pass device='cpu' to run the plain "
            "versions of the kernels"
        )
    return device


def _gq_bucket_stage(colors):
    """Unweighted global PCA -> bucket sort -> per-bucket moments (K1),
    shifted by the global mean (quirk Q1; reference global.c:407,418)."""
    tot = M.total_moments(colors)
    mean = M.moments_center(tot)
    axis, _ = eigen3.principal_axis(M.moments_cov(tot))
    proj = M.project(colors, axis)
    buckets = M.bucketize(proj, GQ.BUCKET_COUNT, torch.min(proj),
                          torch.max(proj))
    bm = M.segment_moments(colors, buckets, GQ.BUCKET_COUNT, shift=mean)
    return buckets, bm


def _lq_stage(colors, weights, buckets, cuts, k0, palette_size,
              batch_splits):
    labels0 = GQ.labels_from_cuts(buckets, cuts)
    labels, count = LQ.lq_quantize(colors, weights, labels0, k0,
                                   palette_size, batch_splits=batch_splits)
    centers, mass = PAL.centers_from_labels(colors, weights, labels,
                                            palette_size)
    valid = (torch.arange(palette_size, device=colors.device) < count) & (
        mass > 0.0)
    return labels, count, centers, valid


def _gq_lq_palette(x_lq, w_lq, p, batch_splits, verbose, timer):
    """GQ (device moments + host f64 DP) then LQ on prepared samples."""
    buckets, bm = _gq_bucket_stage(x_lq)
    bm_np = bm.to(torch.float64).cpu().numpy()
    timer.lap("gq-moments")
    cuts = GQ.gq_host(bm_np, p)
    k0 = len(cuts) - 1
    _log(verbose, f"Base cluster count: {k0}")
    timer.lap("gq-dp")
    out = _lq_stage(x_lq, w_lq, buckets, cuts, k0, p,
                    max(1, int(batch_splits)))
    timer.lap("lq")
    return out


def _gather(channels, idx):
    """Planar channels -> interleaved (M, 3) subsample by index."""
    return torch.stack([ch[idx] for ch in channels], dim=-1).contiguous()


def _finish_palette(palette_work, valid, p, csp):
    """Working-space palette -> sRGB f64 with [-1,-1,-1] fill
    (patolette.c:328)."""
    pal_srgb = cs.working_to_srgb(palette_work, csp).cpu().numpy()
    valid_np = valid.cpu().numpy()
    palette = np.full((p, 3), -1.0)
    palette[valid_np] = pal_srgb[valid_np].astype(np.float64)
    return palette


def _put(colors, device):
    """(N, 3) host pixels -> (N, 3) f32 sRGB in [0, 1] on the device;
    uint8 goes up as bytes and is normalised there."""
    if colors.dtype == np.uint8:
        x = torch.from_numpy(np.ascontiguousarray(colors)).to(device)
        return x.to(torch.float32) * np.float32(1.0 / 255.0)
    return torch.from_numpy(
        np.ascontiguousarray(colors, dtype=np.float32)).to(device)


def _upload(colors, device):
    """(N, 3) host image -> 3 x (N,) f32 sRGB channels on the device."""
    x = _put(colors, device)
    return tuple(x[:, k].contiguous() for k in range(3))


def _put_weights(w_host, device):
    return None if w_host is None else torch.from_numpy(
        np.ascontiguousarray(w_host, dtype=np.float32)).to(device)


def _device_budget(device):
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        return int(total * DEVICE_BUDGET_FRACTION)
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
    under ``verbose``).

    Internal failures, and calls this slice does not cover yet, return
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
        msg = errors.exit_code_message(errors.ExitCode.BAD_QUANT)
        detail = str(e).strip().splitlines()
        detail = detail[0] if detail else ""
        return False, None, None, f"{msg} [{type(e).__name__}: {detail}]"


def _quantize_body(width, height, colors, palette_size, *, dither,
                   palette_only, color_space, tile_size, kmeans_niter,
                   kmeans_max_samples, verbose, weights, lq_max_samples,
                   lq_batch_splits, dither_segment, seed, mesh, device,
                   sync_stages):
    colors = np.asarray(colors)
    if colors.ndim != 2 or colors.shape[1] != 3:
        ch = colors.shape[1] if colors.ndim == 2 else colors.ndim
        return False, None, None, errors.BAD_CHANNEL_COUNT.format(ch)
    if colors.shape[0] != width * height:
        return False, None, None, errors.COLOR_MISMATCH
    if tile_size < 0:
        return False, None, None, errors.BAD_TILE_SIZE
    code = errors.validate_dims(width, height, palette_size)
    if code != errors.ExitCode.SUCCESS:
        return False, None, None, errors.exit_code_message(code)

    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device) is not ported yet")
    device = _resolve_device(device)
    n = width * height
    p = int(palette_size)
    dither = bool(dither) and not palette_only
    saliency = weights is None and tile_size > 0
    timer = _StageTimer(verbose, verbose or sync_stages, device)

    # --- the sampled route (pipeline.py:1003-1024 of the JAX package) ---
    csp = int(color_space)
    lut_eligible = colors.dtype == np.uint8 and not dither and p <= 65536
    m_pal = n if not lq_max_samples else min(n, int(lq_max_samples))
    if kmeans_niter > 0:
        m_pal = max(m_pal,
                    min(n, KM.subsample_cap(p, int(kmeans_max_samples))))
    if (not saliency and m_pal <= SAMPLE_MAX
            and (palette_only or (lut_eligible and n >= _lut_min_pixels(p)))):
        return _quantize_via_samples(
            colors, p, palette_only=palette_only, csp=csp,
            kmeans_niter=int(kmeans_niter),
            kmeans_max_samples=int(kmeans_max_samples), verbose=verbose,
            weights=weights, lq_max_samples=int(lq_max_samples),
            lq_batch_splits=int(lq_batch_splits), seed=int(seed),
            device=device, timer=timer,
        )

    per_pixel = (BYTES_PER_PIXEL_SALIENCY_OR_DITHER if saliency or dither
                 else BYTES_PER_PIXEL)
    if n * per_pixel > _device_budget(device):
        raise NotImplementedError(
            f"{n} pixels exceed the device budget; strip streaming is not "
            "ported yet"
        )
    return _quantize_resident(
        colors, int(width), int(height), p,
        palette_only=palette_only, dither=dither,
        dither_segment=int(dither_segment),
        tile_size=float(tile_size) if saliency else 0.0, csp=csp,
        kmeans_niter=int(kmeans_niter),
        kmeans_max_samples=int(kmeans_max_samples), verbose=verbose,
        weights=weights, lq_max_samples=int(lq_max_samples),
        lq_batch_splits=int(lq_batch_splits), seed=int(seed), device=device,
        timer=timer,
    )


def _draw_palette_samples(colors, n, w_host, rng, p, lq_max_samples,
                          kmeans_niter, kmeans_max_samples, device):
    """Host-side LQ + KMeans sample draws, uploaded and normalised.

    The JAX package's ``_draw_palette_samples`` (pipeline.py:243-290) draw
    for draw: the LQ draw, then a KMeans draw when n exceeds the KMeans cap
    unless the LQ sample can stand in for it (S11: unweighted, and the LQ
    sample already has the cap's size), weights gathered by the same
    indices. Returns ``(x_lq, w_lq, x_km, w_km)``: (M, 3) f32 sRGB
    samples and (M,) f32 weights on the device, ``x_km`` None under S11.
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

    x_km = None if sub_km_h is None else _put(sub_km_h, device)
    return (_put(sub, device), _put_weights(w_lq_h, device), x_km,
            _put_weights(w_km_h, device))


def _quantize_via_samples(colors, p, *, palette_only, csp, kmeans_niter,
                          kmeans_max_samples, verbose, weights,
                          lq_max_samples, lq_batch_splits, seed, device,
                          timer):
    """Sample-upload + LUT route: device work independent of N.

    The palette search needs only its deterministic samples (lq_max_samples
    for GQ/LQ; the reference's own KMeans cap, refine.c:87), so only those
    go to the device. The palette map of a uint8 image factors through the
    2^24 possible colours (``ops/lut.py``): K5 builds one table, it comes
    back in one raw copy, and the host resolves every pixel. The JAX package's staged variant
    (pipeline.py:563-614); its single-program variant is not ported
    (README divergence T3).
    """
    n = colors.shape[0]
    rng = np.random.default_rng(seed)
    w_host = (None if weights is None
              else np.asarray(weights, np.float32).reshape(-1))

    x_lq, w_lq, x_km, w_km = _draw_palette_samples(
        colors, n, w_host, rng, p, lq_max_samples, kmeans_niter,
        kmeans_max_samples, device,
    )
    x_lq = cs.srgb_to_working(x_lq, csp)
    timer.lap("sample-in")

    _log(verbose, "Palette generation")
    _, _, centers, valid = _gq_lq_palette(
        x_lq, w_lq, p, lq_batch_splits, verbose, timer
    )

    if kmeans_niter > 0:
        _log(verbose, "KMeans refinement")
        if x_km is None:  # S11: reuse the LQ sample
            x_km, w_km = x_lq, w_lq
        else:
            x_km = cs.srgb_to_working(x_km, csp)
        centers = KM.lloyd_iterations(x_km, w_km, centers, valid,
                                      kmeans_niter)
        timer.lap("kmeans")

    palette_map = None
    if not palette_only:
        _log(verbose, "NN mapping (24-bit LUT)")
        table = LUT.build_lut_device(centers, valid, csp, LUT.lut_dtype(p))
        timer.lap("lut-build")
        table = table.cpu()
        timer.lap("lut-build+pull")
        palette_map = LUT.lut_map_host(colors, table)
        timer.lap("lut-map-host")

    palette = _finish_palette(centers, valid, p, csp)
    return True, palette, palette_map, errors.exit_code_message(
        errors.ExitCode.SUCCESS
    )


def _quantize_resident(colors, width, height, p, *, palette_only, dither,
                       dither_segment, tile_size, csp, kmeans_niter,
                       kmeans_max_samples, verbose, weights, lq_max_samples,
                       lq_batch_splits, seed, device, timer):
    """The resident route: planar image on the device end to end."""
    n = width * height
    xp_srgb = _upload(colors, device)
    # weights: explicit > saliency (tile_size > 0 only without them) > none
    w_full = None
    if weights is not None:
        w_full = _put_weights(np.asarray(weights).reshape(-1), device)
    timer.lap("stage-in")

    if tile_size > 0:
        _log(verbose, "Generating saliency map")
        w_full = SAL.get_weights_planar(xp_srgb, height, width, tile_size)
        timer.lap("saliency")

    xp_work = cs.srgb_to_working(xp_srgb, csp)
    del xp_srgb
    _log(verbose, "Palette generation")

    rng = np.random.default_rng(seed)
    if lq_max_samples and n > lq_max_samples:
        idx = torch.from_numpy(
            rng.integers(0, n, size=lq_max_samples, dtype=np.int32)
        ).to(device).long()
        x_lq = _gather(xp_work, idx)
        w_lq = None if w_full is None else w_full[idx]
    else:
        x_lq = torch.stack(xp_work, dim=-1).contiguous()
        w_lq = w_full
    timer.lap("to-working+sample")

    _, _, centers, valid = _gq_lq_palette(
        x_lq, w_lq, p, lq_batch_splits, verbose, timer
    )

    if kmeans_niter > 0:
        _log(verbose, "KMeans refinement")
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
        timer.lap("kmeans")

    palette_map = None
    if dither:
        _log(verbose, "Dithering")
        palette_map = DITH.riemersma_dither_planar(
            xp_work, centers, valid, width, height, csp,
            segment=dither_segment,
        ).cpu().numpy()
        timer.lap("dither")
    elif not palette_only:
        _log(verbose, "NN mapping")
        xi = cs.working_to_ictcp(xp_work, csp)
        pi = cs.working_to_ictcp(centers, csp)
        palette_map = assign_planar(xi, pi, valid).cpu().numpy()
        timer.lap("nn-map")

    palette = _finish_palette(centers, valid, p, csp)
    timer.lap("palette-out")
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
