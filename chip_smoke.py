#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (patolette_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card, its power limit, the torch / CUDA / nvcc versions;
  2. build: compiles the kernels from this checkout's csrc/ (nvcc, sm_90a);
  3. kernels: each kernel against its plain-PyTorch version on the card at
     the main path's shapes (max deviation, label agreement), timed with
     CUDA events beside the plain version, a PyTorch library call where one
     computes the same function, and the least time the card could take;
  4. e2e: quantize() of a 4K float32 image to 256 colours with 32 KMeans
     iterations through the kernels (every launch counter must move, two
     runs must agree bit for bit), the same call on uint8 input, and the
     golden 96x64 inputs against tests/golden/quantize_golden.npz.
With ``--profile`` the e2e phase also traces one call with torch.profiler
(device busy share, kernels by device time). With ``--out DIR`` the ptxas
report and the profiler table are written to DIR. Then the nvidia-smi
line, the kernels line and, last, the ok line. Any
failed check raises and the script exits non-zero; without a CUDA device
(or without the package beside it) it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
DEV = "cuda"


def _out_dir():
    """The directory given with ``--out``, or None."""
    args = sys.argv[1:]
    if "--out" in args and args.index("--out") + 1 < len(args):
        out = pathlib.Path(args[args.index("--out") + 1])
        out.mkdir(parents=True, exist_ok=True)
        return out
    return None

# H100 SXM published peaks (dense): HBM bytes/s and f32 non-tensor FLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes, flops):
    """Least time for the work: the larger of bytes over the memory rate
    and f32 operations over the f32 rate; also which one bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


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
          "library": str(build.build().relative_to(ROOT)),
          "ptxas": ptxas[:16]})


def _working_pixels(torch, n, seed):
    """n pixels of an image-like ICtCp distribution on the card."""
    from patolette_tpu_torch.ops import colorspace as cs

    g = torch.Generator(device=DEV).manual_seed(seed)
    base = torch.rand((n, 3), generator=g, device=DEV)
    return cs.srgb_to_working(base, 2).contiguous()


def kernel_k1(torch, rows):
    from patolette_tpu_torch.kernels.segment import (segment_sum,
                                                     segment_sum_plain)
    from patolette_tpu_torch.ops import moments as M

    n = 1 << 18
    x = _working_pixels(torch, n, 1)
    for s, f in ((512, 11), (256, 4)):
        g = torch.Generator(device=DEV).manual_seed(s)
        ids = torch.randint(0, s, (n,), generator=g, device=DEV,
                            dtype=torch.int32)
        if f == 11:
            feats = M.moment_features(x, shift=x.mean(0)).contiguous()
        else:
            feats = torch.cat([torch.ones((n, 1), device=DEV), x],
                              1).contiguous()
        got = segment_sum(feats, ids, s)
        twin = segment_sum_plain(feats, ids, s)
        again = segment_sum(feats, ids, s)
        torch.cuda.synchronize()
        err = float((got - twin).abs().max())
        # f32 sums of n/S terms in two orders: a few ulps of sum |x|
        tol = 1e-5 * float(segment_sum_plain(feats.abs(), ids, s).max())
        check(err <= tol, f"K1 ({s},{f}) deviates {err} > {tol}")
        check(torch.equal(got, again), f"K1 ({s},{f}) not deterministic")
        ms = time_ms(lambda: segment_sum(feats, ids, s))
        plain = time_ms(lambda: segment_sum_plain(feats, ids, s))
        idsl = ids.long()
        lib = time_ms(lambda: torch.zeros((s, f), device=DEV).index_add_(
            0, idsl, feats))
        b, by = bound_ms(n * f * 4 + n * 4 + s * f * 4, n * f)
        rows.append(dict(name=f"segment_sum[{s}x{f}]", shape=[n, s, f],
                         max_abs_err=err, tol=tol, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b, bound_by=by))


def kernel_k2(torch, rows):
    from patolette_tpu_torch.kernels.lq import (lq_candidates,
                                                lq_candidates_plain)
    from patolette_tpu_torch.ops import eigen3
    from patolette_tpu_torch.ops import moments as M

    n, c, nb = 1 << 18, 16, 512
    x = _working_pixels(torch, n, 2)
    g = torch.Generator(device=DEV).manual_seed(3)
    cand = torch.randint(0, c + 1, (n,), generator=g, device=DEV,
                         dtype=torch.int32)  # c = no candidate
    member = cand < c
    wm = torch.where(member, 1.0, 0.0).to(torch.float32).contiguous()
    m1 = M.segment_matmul(torch.cat([wm[:, None], wm[:, None] * x], 1)
                          .contiguous(), cand, c)
    mu = m1[:, 1:4] / m1[:, 0:1].clamp_min(1e-30)
    xs = x - torch.cat([mu, torch.zeros((1, 3), device=DEV)])[cand.long()]
    mom = M.segment_moments(xs, cand, c, weights=wm)
    axis, evals = eigen3.principal_axis(M.moments_cov(mom))
    pmax = 4.0 * evals[:, 2].clamp_min(0.0).sqrt()
    scale = M.bucket_scale(2.0 * pmax)
    tab = torch.cat([mu, axis, -pmax[:, None], scale[:, None]],
                    1).contiguous()
    got, bucket = lq_candidates(x, wm, cand, tab, nb)
    twin, tbucket = lq_candidates_plain(x, wm, cand, tab, nb)
    again, _ = lq_candidates(x, wm, cand, tab, nb)
    torch.cuda.synchronize()
    err = float((got - twin).abs().max())
    agree = _agreement(bucket[member], tbucket[member])
    # bf16-rounded features summed in f32 in two orders
    tol = 1e-5 * float(twin.abs().max())
    check(agree == 1.0, f"K2 buckets agree only {agree}")
    check(err <= tol, f"K2 deviates {err} > {tol}")
    check(torch.equal(got, again), "K2 not deterministic")
    ms = time_ms(lambda: lq_candidates(x, wm, cand, tab, nb))
    plain = time_ms(lambda: lq_candidates_plain(x, wm, cand, tab, nb),
                    reps=10, warm=1)
    members = int(member.sum())
    b, by = bound_ms(n * (12 + 4 + 4) + c * 32 + n * 4 + c * nb * 20,
                     members * 24)
    rows.append(dict(name="lq_candidates", shape=[n, c, nb],
                     max_abs_err=err, tol=tol, bucket_agreement=agree,
                     ms=ms, plain_ms=plain, library_ms=None, bound_ms=b,
                     bound_by=by))


def kernel_k3(torch, rows):
    from patolette_tpu_torch.kernels.assign import (assign_planar,
                                                    assign_planar_plain)

    n, p = 3840 * 2160, 256
    x = _working_pixels(torch, n, 4)
    chans = tuple(x[:, k].contiguous() for k in range(3))
    g = torch.Generator(device=DEV).manual_seed(5)
    centers = x[torch.randint(0, n, (p,), generator=g,
                              device=DEV)].contiguous()
    valid = torch.ones(p, dtype=torch.bool, device=DEV)
    valid[-3:] = False
    got = assign_planar(chans, centers, valid)
    twin = assign_planar_plain(chans, centers, valid)
    torch.cuda.synchronize()
    agree = _agreement(got, twin)
    check(agree == 1.0, f"K3 labels agree only {agree}")
    ms = time_ms(lambda: assign_planar(chans, centers, valid))
    plain = time_ms(lambda: assign_planar_plain(chans, centers, valid),
                    reps=10, warm=1)
    cv = centers[valid]
    lib = time_ms(lambda: torch.cdist(x, cv).argmin(1), reps=10, warm=1)
    b, by = bound_ms(n * 12 + p * 16 + n * 4, n * int(valid.sum()) * 7)
    rows.append(dict(name="assign_planar", shape=[n, p], label_agreement=agree,
                     max_abs_err=float((got != twin).sum()), ms=ms,
                     plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by))


def kernel_k4(torch, rows):
    from patolette_tpu_torch.kernels.kmeans import (kmeans_step,
                                                    kmeans_step_plain)

    m, p, iters = 1 << 18, 256, 4
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
    ms = time_ms(lambda: kmeans_step(x, None, c0, valid))
    plain = time_ms(lambda: kmeans_step_plain(x, None, c0, valid),
                    reps=10, warm=1)
    b, by = bound_ms(m * 12 + p * 12 * 2 + p * 4,
                     m * int(valid.sum()) * 7 + m * 4)
    rows.append(dict(name="kmeans_step", shape=[m, p, iters],
                     label_agreement=agree, max_abs_err=err,
                     max_abs_err_after_iters=err_iters, ms=ms,
                     plain_ms=plain, library_ms=None, bound_ms=b,
                     bound_by=by))


def phase_kernels(torch):
    rows = []
    kernel_k1(torch, rows)
    kernel_k2(torch, rows)
    kernel_k3(torch, rows)
    kernel_k4(torch, rows)
    for r in rows:
        emit(dict(phase="kernel", **r))
    return rows


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


def _profile_call(torch, call):
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
        (out_dir / "profile.txt").write_text(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    emit({"phase": "profile", "wall_ms": wall_us / 1e3,
          "device_ms": device_us / 1e3,
          "device_busy_share": device_us / wall_us,
          "top": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                  for e in top]})


def phase_e2e(torch, profile=False):
    import numpy as np

    import patolette_tpu_torch as pt
    from patolette_tpu_torch import kernels
    from patolette_tpu_torch.models import pipeline

    w, h, p = 3840, 2160, 256
    img = synth_image_f32(w, h)
    kw = dict(dither=False, tile_size=0, kmeans_niter=32,
              color_space=pt.ColorSpace_ICtCp)

    def run(colors, **extra):
        ok, pal, pmap, msg = pt.quantize(w, h, colors, p, **kw, **extra)
        check(ok, f"quantize failed: {msg}")
        return pal, pmap

    t0 = time.perf_counter()
    run(img)
    warm_s = time.perf_counter() - t0

    kernels.reset_launches()
    t0 = time.perf_counter()
    pal, pmap = run(img)
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} not launched on the main path")
    walls, laps = [first_s], [dict(pipeline.LAST_STAGE_TIMES)]
    for _ in range(2):
        t0 = time.perf_counter()
        pal2, pmap2 = run(img)
        walls.append(time.perf_counter() - t0)
        laps.append(dict(pipeline.LAST_STAGE_TIMES))
    check(np.array_equal(pal, pal2) and np.array_equal(pmap, pmap2),
          "two runs differ")
    run(img, sync_stages=True)
    synced = dict(pipeline.LAST_STAGE_TIMES)

    check(pal.shape == (p, 3) and pmap.shape == (w * h,), "bad shapes")
    check(pmap.dtype == np.int32 and pmap.min() >= 0 and pmap.max() < p,
          "bad map")
    used = pal[:, 0] >= 0
    check(np.isfinite(pal).all() and (pal[used] <= 1).all()
          and (pal[used] >= 0).all() and used[np.unique(pmap)].all(),
          "bad palette")
    mse, mse_cube = _mse_luv(torch, img, pal, pmap)
    check(np.isfinite(mse) and mse < 0.5 * mse_cube,
          f"CIELuv MSE {mse} against {mse_cube} for the 216-colour cube")

    img_u8 = np.round(img * 255.0).astype(np.uint8)
    t0 = time.perf_counter()
    pal8, pmap8 = run(img_u8)
    u8_s = time.perf_counter() - t0
    mse8, cube8 = _mse_luv(torch, img_u8.astype(np.float32) / 255.0, pal8,
                           pmap8)
    check(np.isfinite(mse8) and mse8 < 0.5 * cube8,
          f"uint8 CIELuv MSE {mse8} against {cube8} for the cube")

    if profile:
        _profile_call(torch, lambda: run(img))

    best = min(walls)
    emit({"phase": "e2e", "shape": [w, h], "palette": p, "kmeans_niter": 32,
          "warmup_s": warm_s, "wall_s": walls, "best_s": best,
          "mp_per_s": w * h / 1e6 / best, "stage_ms": laps[walls.index(best)],
          "stage_ms_synced": synced, "launches": launches,
          "cieluv_mse": mse, "cieluv_mse_cube216": mse_cube,
          "palette_used": int(used.sum()),
          "uint8_wall_s": u8_s, "uint8_cieluv_mse": mse8,
          "bit_identical_runs": True})
    return launches


def phase_golden(torch):
    """Small-input reference: the golden configs of the main path."""
    import numpy as np

    import patolette_tpu_torch as pt

    golden = np.load(ROOT / "tests" / "golden" / "quantize_golden.npz")
    out = {"phase": "golden"}
    for name, p, kw in (
        ("cieluv_plain", 32, dict(kmeans_niter=0,
                                  color_space=pt.ColorSpace_CIELuv)),
        ("ictcp_kmeans8", 24, dict(kmeans_niter=8,
                                   color_space=pt.ColorSpace_ICtCp)),
    ):
        ok, pal, pmap, msg = pt.quantize(96, 64, _golden_image(), p,
                                         dither=False, tile_size=0, **kw)
        check(ok, msg)
        err = float(np.abs(pal - golden[f"{name}__palette"]).max())
        hist = np.bincount(pmap, minlength=p)
        moved = int(np.abs(hist - golden[f"{name}__hist"]).sum())
        out[name] = {"palette_max_abs_err": err, "hist_l1": moved}
        # the card sums in another order than the CPU: a palette entry
        # may move by a few ulps of the PQ curve, a handful of pixels
        # may change entry at near-ties
        check(err <= 1e-3, f"golden {name}: palette deviates {err}")
        check(moved <= 0.005 * len(pmap), f"golden {name}: {moved} moved")
    emit(out)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "patolette_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device(torch)
    phase_build()
    rows = phase_kernels(torch)
    launches = phase_e2e(torch, profile="--profile" in sys.argv[1:])
    phase_golden(torch)

    sources = {
        "segment_sum": ("patolette_tpu_torch/csrc/segment_sum.cu",
                        "patolette_tpu/ops/moments.py:108"),
        "lq_candidates": ("patolette_tpu_torch/csrc/lq_candidates.cu",
                          "patolette_tpu/models/local_q.py:87"),
        "assign_planar": ("patolette_tpu_torch/csrc/assign.cu",
                          "patolette_tpu/ops/assign.py:81"),
        "kmeans_step": ("patolette_tpu_torch/csrc/kmeans.cu",
                        "patolette_tpu/models/kmeans.py:104"),
    }
    line = []
    for r in rows:
        key = r["name"].split("[")[0]
        src, replaces = sources[key]
        line.append({
            "name": r["name"], "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
