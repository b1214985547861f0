"""Per-call host time of one layer, from the program's stage laps."""

from __future__ import annotations

from portbench.harness import manifest


def layer_mean_ms(ctx, layer):
    """Mean over the window's calls of the laps ``laps.json`` puts in
    ``layer``; None (said on standard error) when no call has any."""
    layers = manifest.lap_layers()
    mine = {lap for lap, lay in layers.items() if lay == layer}
    per_call = [sum(ms for lap, ms in c["laps"].items() if lap in mine)
                for c in ctx.calls]
    if not any(lap in mine for c in ctx.calls for lap in c["laps"]):
        seen = sorted({lap for c in ctx.calls for lap in c["laps"]})
        ctx.log(f"layer {layer!r}: none of its laps {sorted(mine)} in "
                f"{len(ctx.calls)} calls (laps seen: {seen})")
        return None
    return sum(per_call) / len(per_call)


def unmapped(calls):
    """Lap names of ``calls`` that ``laps.json`` puts in no layer, sorted:
    their time would be in no layer's metric."""
    layers = manifest.lap_layers()
    return sorted({lap for c in calls for lap in c["laps"]
                   if lap not in layers})
