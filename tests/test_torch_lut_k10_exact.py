"""The exactness arguments of K5's pruned scan and K10's pow_exact, on the
CPU.

K5 (``csrc/nearest.cuh``): each warp scans only the palette entries that
can be nearest somewhere in the box of its points.
``kernels.lut.box_candidates`` is that rule in numpy; over warp patches of
the real grid (the brick layout K5 uses and the linear one K3 uses, codes
built only for those patches), the first minimum over each patch's
candidate list must equal ``lut_argmin_plain`` on the same codes exactly,
for random palettes of 1, 256 and 1024 entries and the adversarial ones
(duplicates, ties on the faces between patches, invalid slots, entries far
outside the gamut); so must the JAX package's ``_argmin_lut``, except where
its compiled dot product rounds otherwise than the port's unfused ``(xa ca
+ xb cb) + xc cc``: there the two entries picked must be within f32
rounding of each other in exact distance (a point or two of the 65536 on
the faces and random1024 palettes).

K10 (``csrc/colorspace.cu``): ``kernels.colorspace.pow_exact_model`` is
``pow_exact`` in numpy, the same tables and f64 operations; wherever its
fast path is taken, its f32 must equal the f64 power rounded to f32, on
2^20 strided positive f32 inputs of each exponent and the special values.
The tables it reads from the source must be what the source's comment
says they are. The uint8 decode table built with it must equal the glue's
decode of all 256 byte values.
"""

from decimal import Decimal, getcontext
from math import factorial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patolette_tpu.ops import lut as JL
from patolette_tpu_torch.kernels import colorspace as KC
from patolette_tpu_torch.kernels import lut as KL
from patolette_tpu_torch.kernels.assign import assign_planar_plain
from patolette_tpu_torch.ops import colorspace as cs
from patolette_tpu_torch.ops import lut as TL
from test_torch_cores import share_cores  # noqa: F401

PATCHES = 128  # of each layout


def _grid_at(codes):
    planes = TL._codes_to_ictcp(torch.from_numpy(
        np.asarray(codes, np.int64).astype(np.int32)), 2)
    return torch.stack(planes, 1).numpy()


@pytest.fixture(scope="module")
def patches():
    """(2 * PATCHES, 256) codes: random warps of the 2^24 grid in the brick
    and the linear layout, and their (.., 256, 3) ICtCp values."""
    rng = np.random.default_rng(0)
    codes = np.stack(
        [KL.warp_codes(int(w), brick=True)
         for w in rng.integers(0, (1 << 24) // 256, PATCHES)]
        + [KL.warp_codes(int(w), brick=False)
           for w in rng.integers(0, (1 << 24) // 256, PATCHES)])
    return codes, _grid_at(codes.reshape(-1)).reshape(*codes.shape, 3)


def _palettes():
    out = {}
    for p in (1, 256, 1024):
        g = torch.Generator().manual_seed(20 + p)
        pal = cs.srgb_to_working(torch.rand((p, 3), generator=g), 2)
        valid = np.ones(p, bool)
        valid[-3:] = p < 4
        out[f"random{p}"] = (pal.numpy(), valid)
    out.update(KL.adversarial_palettes(_grid_at, seed=1))
    return out


PALETTES = _palettes()


@pytest.mark.parametrize("name", sorted(PALETTES))
def test_pruned_argmin_is_the_full_argmin(patches, name):
    codes, values = patches
    centers, valid = PALETTES[name]
    cen_t = torch.from_numpy(centers)
    planes = tuple(torch.from_numpy(values[..., k].reshape(-1).copy())
                   for k in range(3))
    want = KL.lut_argmin_plain(planes, cen_t, torch.from_numpy(valid),
                               torch.int32).numpy()
    pi = jnp.asarray(centers)
    c2 = jnp.where(jnp.asarray(valid), jnp.sum(pi * pi, axis=-1), jnp.inf)
    jax_lut = np.asarray(JL._argmin_lut(
        tuple(jnp.asarray(p.numpy())[None] for p in planes), pi, c2,
        jnp.int32))
    differ = np.flatnonzero(want != jax_lut)
    x = values.reshape(-1, 3)[differ].astype(np.float64)
    gap, err = 0.0, 0.0
    for sign, k in ((1, want[differ]), (-1, jax_lut[differ])):
        c = centers[k].astype(np.float64)
        gap = gap + sign * ((x - c) ** 2).sum(1)
        err = err + 5 * 2.0 ** -24 * ((c * c).sum(1)
                                      + 2 * (np.abs(x * c)).sum(1))
    assert np.all(np.abs(gap) <= err), (differ, gap, err)
    assert len(differ) <= 4, differ

    got = np.empty_like(want)
    sizes = []
    for w, x in enumerate(values):
        cand = KL.box_candidates(x, centers, valid)
        sizes.append(len(cand))
        assert np.all(np.diff(cand) > 0) and valid[cand].all()
        if len(cand) == 0:
            got[w * 256:(w + 1) * 256] = 0
            continue
        xs = tuple(torch.from_numpy(x[:, k].copy()) for k in range(3))
        sub = assign_planar_plain(xs, cen_t[cand],
                                  torch.ones(len(cand), dtype=torch.bool))
        got[w * 256:(w + 1) * 256] = cand[sub.numpy()]
    np.testing.assert_array_equal(got, want)
    if name == "random1024":  # the rule prunes: a few dozen of 1021
        assert np.mean(sizes) < 64, np.mean(sizes)


def test_far_entries_keep_the_full_list(patches):
    """A centre whose |c|^2 overflows f32 has an infinite error bound, so
    nothing is pruned against it, and it is listed itself."""
    _, values = patches
    centers, valid = PALETTES["far"]
    cand = KL.box_candidates(values[0], centers, valid)
    assert 253 in cand  # the (2e19, 2e19, -2e19) entry


# ---------------------------------------------------------------------------
# pow_exact
# ---------------------------------------------------------------------------

def _reference(x, e):
    with np.errstate(all="ignore"):
        return np.power(x.astype(np.float64), e).astype(np.float32)


@pytest.mark.parametrize("name", sorted(KC.POW_EXPONENTS))
def test_pow_exact_fast_path_is_pow(name):
    e = KC.POW_EXPONENTS[name]
    bits = np.arange(1, 0x7F800000, 2039, dtype=np.uint32)  # 2^20 inputs
    special = np.array([0.0, -0.0, 2.0 ** -149, 1.0, np.inf, -np.inf,
                        np.nan, -1.0, 2.0 ** -126, 3.4028235e38],
                       np.float32)
    x = np.concatenate([bits.view(np.float32), special])
    got, fell = KC.pow_exact_model(x, e)
    want = _reference(x, e)
    fast = ~fell
    np.testing.assert_array_equal(got[fast].view(np.uint32),
                                  want[fast].view(np.uint32))
    # 0 (either sign) gives +0 on the fast path; non-positive and
    # non-finite inputs other than 0 fall back
    assert got[-10] == 0 and not np.signbit(got[-10]) and not fell[-10]
    assert got[-9] == 0 and not np.signbit(got[-9]) and not fell[-9]
    assert fell[-6:-2].all()
    # where the result is an f32-normal number, the fallback is rare
    normal = fast | fell
    with np.errstate(all="ignore"):
        normal &= (want >= np.float32(2.0 ** -126)) & (want < np.inf)
    assert fell[normal].mean() < 1e-3


def test_pow_tables_are_what_the_source_says():
    """c_i has 29 significant bits and is 1 / (1 + (i + 1/2) / 128) rounded
    there; -log2(c_i), 2^(j/128) and the coefficients are the nearest
    doubles to their values."""
    getcontext().prec = 60
    ln2 = Decimal(2).ln()
    log, exp2, lp, ep = KC.pow_tables()
    for i, (c, l) in enumerate(log):
        mant, ex = np.frexp(c)
        assert mant * 2.0 ** 29 == np.round(mant * 2.0 ** 29)
        want = 1 / (1 + (Decimal(i) + Decimal("0.5")) / 128)
        scale = Decimal(2) ** (29 - int(ex))
        assert Decimal(c) == (want * scale).to_integral_value() / scale
        assert l == float(-Decimal(c).ln() / ln2)
    for j, t in enumerate(exp2):
        assert t == float((ln2 * j / 128).exp())
    for k, a in enumerate(lp, 1):
        assert a == float(Decimal((-1) ** (k + 1)) / (k * ln2))
    for k, b in enumerate(ep, 1):
        assert b == float(ln2 ** k / factorial(k))


def test_byte_decode_table_is_the_glue_decode():
    """The table K10 fills for byte inputs, built with pow_exact as the
    kernel builds it, equals the glue's decode of every byte value."""
    f32 = np.float32
    c = np.arange(256).astype(f32) * f32(1.0 / 255.0)
    base = np.maximum(c + f32(0.055), f32(0)) * f32(1.0 / f32(1.055))
    powered, _ = KC.pow_exact_model(base, KC.POW_EXPONENTS["2.4"])
    lin = np.where(c <= f32(0.04045), c * f32(1.0 / f32(12.92)), powered)
    table = np.clip(lin, f32(0), f32(1))
    want = cs.srgb_gamma_decode(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(table.view(np.uint32),
                                  want.view(np.uint32))
