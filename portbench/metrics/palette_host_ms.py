"""palette_host_ms (palette core): the mean per call of the laps that
laps.json puts in the layer (gq-*, lq, kmeans, palette,
palette+lut-build, palette (device), palette-out).
Host time: the laps run without sync_stages, so they hold the host's
enqueue and its waits."""

from portbench.harness.laps import layer_mean_ms


def read(ctx):
    return layer_mean_ms(ctx, "palette core")
