"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 portbench/control.py --workload <name> --seeds <a>-<b> [--control <c>] [--images <n>] [--out DIR]

For each seed: the cell's images (as a run makes them), one program call
each; the reference's numbers of each call (the sound program's readings:
their largest over the seeds is the lower reading of each limit); for the
first ``--control`` seeds also the control's: its map, made by the
reference in bfloat16 from the same palette, and its palette, searched by
the reference in bfloat16, judged the same way (the smallest is the upper
reading). One JSON line a seed on standard
output and, with ``--out``, in ``DIR/control-<workload>.jsonl``. Not run
by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import manifest  # noqa: E402


def readings(cell, seed, with_control, device, quantize, images=None):
    """One seed's readings: ``{"program": {number: [...]}, "control":
    {number: [...]}, "bad_outputs": n}``, one reading an image; a gap
    comes with the count of pixels it left out."""
    from portbench.harness import images as gen
    from portbench.reference import check, control

    cfg, tr = cell["config"], cell["traffic"]
    w, h = int(tr["width"]), int(tr["height"])
    call = dict(cfg["call"])
    p = int(call.pop("palette_size"))
    segment = int(call.get("dither_segment", 4096))
    gaps = [n for n in cell["limits"]
            if n not in ("bad_outputs", "palette_excess")]
    out = {"program": {**{g: [] for g in gaps}, "palette_excess": []},
           "control": {**{g: [] for g in gaps}, "palette_excess": []},
           "bad_outputs": 0}

    def judge(gap, img, pal, pmap):
        if gap == "dither_gap":
            return check.dither_gap(img, pal, pmap, w, h, device, segment)
        if gap == "map_gap":
            return check.map_gap(img, pal, pmap, device)
        return manifest.check(gap).check(img, pal, pmap, w, h, device, cfg)

    def control_map(gap, img, pal):
        if gap == "dither_gap":
            return control.dither_map(img, pal, w, h, device, segment)
        if gap == "map_gap":
            return control.nearest_map(img, pal, device)
        return manifest.check(gap).control(img, pal, w, h, device, cfg)

    for img in gen.make_images(tr, cfg["input_dtype"], seed,
                               device)[:images]:
        ok, pal, pmap, msg = quantize(img, p, call)
        bad = check.bad_outputs(ok, pal, pmap, w * h, p)
        out["bad_outputs"] += bad
        if bad:
            continue
        for gap in gaps:
            out["program"][gap].append(judge(gap, img, pal, pmap))
        ref = check.PaletteReference(img, w, h, cfg["call"], device, seed)
        out["program"]["palette_excess"].append(ref.excess(pal))
        if with_control:
            for gap in gaps:
                cmap = control_map(gap, img, pal)
                out["control"][gap].append(judge(gap, img, pal, cmap))
                del cmap
            out["control"]["palette_excess"].append(
                ref.excess(control.palette(ref)))
        del ref
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="first-last, inclusive")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--images", type=int,
                    help="read the first N images of each seed only")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from patolette_tpu_torch import quantize
    from patolette_tpu_torch.utils.config import ColorSpace

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(manifest.load_benchmark(), args.workload)
    w, h = int(cell["traffic"]["width"]), int(cell["traffic"]["height"])

    def run(img, p, call):
        call = dict(call, color_space=ColorSpace[call["color_space"]])
        return quantize(w, h, img, p, device="cuda", **call)

    first, last = (int(v) for v in args.seeds.split("-"))
    sink = None
    if args.out:
        pathlib.Path(args.out).mkdir(parents=True, exist_ok=True)
        sink = open(pathlib.Path(args.out) / f"control-{args.workload}.jsonl",
                    "a")
    try:
        for i, seed in enumerate(range(first, last + 1)):
            t = time.perf_counter()
            r = readings(cell, seed, i < args.control, "cuda", run,
                         args.images)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "s": time.perf_counter() - t, **r})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
