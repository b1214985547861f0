"""Hand-written CUDA kernels of the port and their plain-PyTorch twins.

One module per kernel: ``segment`` (K1), ``lq`` (K2), ``assign`` (K3),
``kmeans`` (K4), ``lut`` (K5), ``rle`` (K6), ``hilbert`` (K7), ``dither``
(K8), ``mbd`` (K9), ``colorspace`` (K10), ``gq`` (K11). Each wrapper takes
the twin for tensors on the CPU and launches its kernel (or raises) for
tensors on the card; ``LAUNCHES`` counts the wrapper
calls that launched, so a run can show that its path went through them
(a replayed CUDA graph calls none: the LQ loop's K1 and K2 count when
``models/local_q.py`` runs the loop eagerly or captures it, not when it
replays it).
"""

LAUNCHES = {
    "segment_sum": 0,
    "lq_candidates": 0,
    "assign_planar": 0,
    "kmeans_step": 0,
    "lut_argmin": 0,
    "rle_encode_u8_v2": 0,
    "rle_encode_u8": 0,
    "rle_encode_u16_v2": 0,
    "visit_order": 0,
    "dither_scan": 0,
    "mbd": 0,
    "color_convert": 0,
    "gq_dp": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
