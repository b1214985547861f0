"""staging_host_ms (host staging): the mean per call of the laps that
laps.json puts in the layer (stage-in, sample-in, strip-in,
to-working+sample, one-shot).
Host time: the laps run without sync_stages, so they hold the host's
enqueue and its waits."""

from portbench.harness.laps import layer_mean_ms


def read(ctx):
    return layer_mean_ms(ctx, "host staging")
