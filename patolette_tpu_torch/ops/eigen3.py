"""Batched closed-form symmetric 3x3 eigendecomposition.

Port of ``patolette_tpu/ops/eigen3.py``, formula for formula. The
Cayley-Hamilton column choice in :func:`principal_axis` fixes the sign of
the axis, and that sign decides on which side of an LQ cut the mass lands,
so it is kept exactly. Three-term sums and the 3x3 product are written out
as IEEE-rounded f32 ops in a fixed order (same result on CPU and card).
"""

from __future__ import annotations

import math

import torch

from patolette_tpu_torch.utils.device import call_device, on_device

_EPS = 1e-20


def _sum3(a, b, c):
    return (a + b) + c


def eigvals_sym3(a):
    """Eigenvalues of symmetric ``(..., 3, 3)`` matrices, ascending
    (trigonometric method, Smith 1961)."""
    a00 = a[..., 0, 0]
    a11 = a[..., 1, 1]
    a22 = a[..., 2, 2]
    a01 = a[..., 0, 1]
    a02 = a[..., 0, 2]
    a12 = a[..., 1, 2]

    p1 = _sum3(a01 * a01, a02 * a02, a12 * a12)
    q = _sum3(a00, a11, a22) / 3.0
    b00 = a00 - q
    b11 = a11 - q
    b22 = a22 - q
    p2 = _sum3(b00 * b00, b11 * b11, b22 * b22) + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 0.0))
    p_safe = torch.where(p > 0.0, p, 1.0)

    # det((A - qI) / p) / 2
    det_b = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(det_b / (2.0 * (p_safe * p_safe * p_safe)), -1.0, 1.0)

    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo

    # Degenerate (near-spherical) case: p ~ 0 -> all eigenvalues ~ q.
    diag_sorted = torch.sort(torch.stack([a00, a11, a22], dim=-1), dim=-1)[0]
    tiny = p2 <= _EPS
    lo = torch.where(tiny, diag_sorted[..., 0], e_lo)
    mid = torch.where(tiny, diag_sorted[..., 1], e_mid)
    hi = torch.where(tiny, diag_sorted[..., 2], e_hi)
    return torch.stack([lo, mid, hi], dim=-1)


def _matmul33(x, y):
    """Batched 3x3 product with each entry summed as (t0 + t1) + t2."""
    rows = []
    for i in range(3):
        rows.append(torch.stack([
            _sum3(x[..., i, 0] * y[..., 0, j], x[..., i, 1] * y[..., 1, j],
                  x[..., i, 2] * y[..., 2, j])
            for j in range(3)
        ], dim=-1))
    return torch.stack(rows, dim=-2)


def principal_axis(a):
    """Unit eigenvector of the largest eigenvalue of symmetric ``(...,3,3)``.

    Every nonzero column of ``(A - lambda_mid I)(A - lambda_lo I)`` lies in
    the top eigenspace; the largest-norm column (first on ties) is taken.
    Degenerate spectra fall back to the coordinate axis of the largest
    diagonal entry. Returns ``(axis (..., 3), evals ascending (..., 3))``.
    """
    evals = eigvals_sym3(a)
    lo = evals[..., 0]
    mid = evals[..., 1]

    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    a_mid = a - mid[..., None, None] * eye
    a_lo = a - lo[..., None, None] * eye
    m = _matmul33(a_mid, a_lo)

    mm = m * m
    col_norm2 = _sum3(mm[..., 0, :], mm[..., 1, :], mm[..., 2, :])
    best = torch.argmax(col_norm2, dim=-1)  # first max, as jnp.argmax
    v = torch.gather(
        m, -1, best[..., None, None].expand(*m.shape[:-1], 1)
    )[..., 0]
    vnorm2 = _sum3(v[..., 0] * v[..., 0], v[..., 1] * v[..., 1],
                   v[..., 2] * v[..., 2])[..., None]

    diag = torch.stack([a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]], dim=-1)
    # rows picked by a 1-D index: a 0-d index tensor would be read on the
    # host (one matrix, the GQ global axis)
    fallback = eye[torch.argmax(diag, dim=-1).reshape(-1)].reshape(
        diag.shape)

    ok = vnorm2[..., 0] > _EPS
    axis = torch.where(
        ok[..., None],
        v / torch.sqrt(torch.where(ok[..., None], vnorm2, 1.0)),
        fallback,
    )
    return axis, evals


def pca_from_cov(cov, delta=1e-16, device=None):
    """``(axis (..., 3), explained (...))`` of symmetric ``(..., 3, 3)``
    covariances (reference pca.c:122-149, JAX ``eigen3.py:105``): the
    principal axis, and ``lambda_max / sum(lambda)`` where that sum exceeds
    ``delta``, else 0. Numpy input goes to ``device`` (``cuda`` by
    default); tensors stay where they are; f32."""
    cov = on_device(cov, call_device(cov, device), torch.float32)
    axis, evals = principal_axis(cov)
    total = _sum3(evals[..., 0], evals[..., 1], evals[..., 2])
    ok = total > delta
    explained = torch.where(ok, evals[..., 2] / torch.where(ok, total, 1.0),
                            0.0)
    return axis, explained
