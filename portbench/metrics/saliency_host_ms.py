"""saliency_host_ms (saliency): the mean per call of the laps that
laps.json puts in the layer (saliency).
Host time: the laps run without sync_stages, so they hold the host's
enqueue and its waits."""

from portbench.harness.laps import layer_mean_ms


def read(ctx):
    return layer_mean_ms(ctx, "saliency")
