"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``patolette_tpu_torch``. The cell's
images are made on the card from ``--seed`` and brought to host memory;
two warm calls follow; then one caller quantizes them back to back for
``--seconds`` (a closed loop), each call timed on the host clock from the
host image to the host palette and map. With ``--trace 1`` a short
stretch of further calls runs under ``torch.profiler``. Once the window has
closed and the peak memory has been read, the reference judges the
outputs of calls drawn from the seed among all the window's, and the
quality of the window's first calls (one an image). The last line of standard output is the result, one JSON
object; the numbers compared and their limits are the last lines of
standard error. Without a CUDA card the run fails and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import guard, laps, manifest  # noqa: E402


# calls before the window (the first builds the kernels' library and the
# table's grid), and calls drawn from the seed whose gaps are judged
WARM_CALLS = 2
DRAWN_CALLS = 2


def log(msg):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _seed_words(seed):
    return [int(seed) % (1 << 64), 0x706F7274]


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def judge(cell, images, kept, device, seed, log=log):
    """The numbers compared and the quality, from the kept calls'
    outputs: ``(checks, quality, valid entries)``."""
    import numpy as np

    from portbench.reference import check

    cfg, tr = cell["config"], cell["traffic"]
    w, h = int(tr["width"]), int(tr["height"])
    p = int(cfg["call"]["palette_size"])
    limits = cell["limits"]
    segment = int(cfg["call"].get("dither_segment", 4096))
    bad = 0
    values = {name: [] for name in limits if name != "bad_outputs"}
    valid = []
    refs = {}    # image -> the reference's palette search on it
    for i in sorted(kept):
        c = kept[i]
        if not c["ok"]:   # counted with the window's failed calls
            continue
        px = images[c["image"]]
        b = check.bad_outputs(c["ok"], c["palette"], c["map"], w * h, p)
        bad += b
        c["sound"] = not b
        if b:
            log(f"call {i}: {b} bad outputs ({c['message']})")
            continue
        valid.append(int(check.palette_rows(c["palette"])[0].sum()))
        if not c["drawn"]:   # the gaps are read on the drawn calls
            continue
        for name in values:
            if name == "map_gap":
                v, out = check.map_gap(px, c["palette"], c["map"], device)
            elif name == "dither_gap":
                v, out = check.dither_gap(px, c["palette"], c["map"], w, h,
                                          device, segment)
            elif name == "palette_excess":
                if c["image"] not in refs:
                    refs[c["image"]] = check.PaletteReference(
                        px, w, h, cfg["call"], device, seed)
                v, out = refs[c["image"]].excess(c["palette"]), 0
            else:
                v, out = manifest.check(name).check(
                    px, c["palette"], c["map"], w, h, device, cfg)
            log(f"call {i} (image {c['image']}): {name} {v!r}, "
                f"{out} left out")
            values[name].append(v)
    refs.clear()    # the reference's float64 images, before the quality
    checks = {"bad_outputs": {"value": bad, "limit": limits["bad_outputs"]}}
    for name, vs in values.items():
        checks[name] = {"value": max(vs) if vs else None,
                        "limit": limits[name]}
    rng = np.random.default_rng(_seed_words(seed))
    mse = [check.mse_luv(images[c["image"]], c["palette"], c["map"], device,
                         rng)
           for i, c in sorted(kept.items()) if c["first"] and c.get("sound")]
    quality = {"mse_luv": sum(mse) / len(mse)} if mse else {}
    valid = sorted(valid)[len(valid) // 2] if valid else p
    return checks, quality, valid


def run_cell(cell, seed, seconds, trace, device, t0, log=log,
             quantize=None):
    """One run of ``cell``: the result's dict. ``quantize`` replaces the
    program's entry (tests break the timed path with it)."""
    import numpy as np
    import torch

    from patolette_tpu_torch.models import pipeline
    from patolette_tpu_torch.utils.config import ColorSpace
    from portbench.harness import images as gen
    from portbench.harness import trace as tracing

    quantize = quantize or pipeline.quantize
    cfg, tr = cell["config"], cell["traffic"]
    w, h = int(tr["width"]), int(tr["height"])
    n = w * h
    call = dict(cfg["call"])
    p = int(call.pop("palette_size"))
    call["color_space"] = ColorSpace[call["color_space"]]
    cuda = torch.device(device).type == "cuda"

    images = gen.make_images(tr, cfg["input_dtype"], seed, device)
    k = len(images)

    def one(i):
        return quantize(w, h, images[i % k], p, device=device, **call)

    for i in range(WARM_CALLS):
        ok, _, _, msg = one(i)
        if not ok:
            log(f"warm call {i} failed: {msg}")
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    rng = np.random.default_rng(_seed_words(seed))
    drawn = DRAWN_CALLS
    reservoir, kept, calls = [], {}, []
    setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    deadline = start + float(seconds)
    i = 0
    while True:
        a = time.perf_counter()
        ok, pal, pmap, msg = one(i)
        b = time.perf_counter()
        calls.append({"ms": (b - a) * 1e3,
                      "laps": dict(pipeline.LAST_STAGE_TIMES),
                      "ok": bool(ok)})
        if not ok and sum(not c["ok"] for c in calls) <= 3:
            log(f"call {i} failed: {msg}")
        # the first call of each image, and a reservoir of calls drawn
        # from the seed among all the window's
        keep = i < k
        if len(reservoir) < drawn:
            reservoir.append(i)
            keep = True
        else:
            j = int(rng.integers(0, i + 1))
            if j < drawn:
                old = reservoir[j]
                reservoir[j] = i
                if old >= k:
                    kept.pop(old, None)
                keep = True
        if keep:
            kept[i] = {"image": i % k, "ok": bool(ok), "palette": pal,
                       "map": pmap, "message": msg, "first": i < k}
        del pal, pmap
        i += 1
        if b >= deadline:
            break
    window_s = b - start
    peak = torch.cuda.max_memory_allocated() if cuda else None
    for j, c in kept.items():
        c["drawn"] = j in reservoir

    trace_obj, traced_laps = None, []
    if trace:
        def traced(j):
            one(j)
            traced_laps.append(dict(pipeline.LAST_STAGE_TIMES))

        trace_obj = tracing.profile_calls(traced, int(tr["trace_calls"]))

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, quality, valid = judge(cell, images, kept, device, seed, log)
    failed = sum(not c["ok"] for c in calls)
    checks["bad_outputs"]["value"] += failed
    ms = sorted(c["ms"] for c in calls)
    log(f"{len(calls)} calls in {window_s:.3f} s: ms min {ms[0]:.1f} "
        f"median {ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}")
    unmapped = laps.unmapped(calls)
    if unmapped:
        log(f"laps that laps.json puts in no layer: {unmapped}")

    ctx = types.SimpleNamespace(
        cell=cell, n=n, calls=calls, setup_s=setup_s, window_s=window_s,
        pixels_done=n * len(calls), peak_bytes=peak, quality=quality,
        trace=trace_obj, traced_laps=traced_laps, valid=valid, log=log)
    metrics = {}
    for m in cell["per_layer" if trace else "end_to_end"]:
        v = manifest.reader(m["name"])(ctx)
        if v is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        entry = v if isinstance(v, dict) else {"value": v}
        metrics[m["name"]] = {"value": float(entry.pop("value")),
                              "unit": m["unit"], **entry}

    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": int(cell["workload"]["chips"]),
        "memory_peak_bytes": peak,
    }
    if cuda:
        device_info["power_limit_w"] = _power_limit()
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace_obj is not None and trace_obj.calls:
        device_info["busy_s"] = trace_obj.busy_s()
        device_info["window_s"] = trace_obj.window_s()
        result["breakdown"] = {
            "device_ops": trace_obj.device_ops(),
            "idle_gaps": trace_obj.idle_gaps(traced_laps)}
    result["checks"] = checks
    return result


def main(argv=None):
    args = parse(argv)
    try:
        cell = manifest.cell(manifest.load_benchmark(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        log(f"cannot load the cell: {e!r}")
        return 2
    import torch

    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0)
    found = guard.forbidden_loaded()
    if found:
        log(f"modules of the JAX side are loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
