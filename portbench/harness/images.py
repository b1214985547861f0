"""The one image generator: bench.py's texture, on the card, from a seed.

A tile of sines and cosines with Gaussian noise in the third channel,
tiled to the image's size, plus a full-height gradient in the third
channel, clipped to [0, 1]: the image is not k-colourable. The traffic
file gives the sizes, the generator's parameters and each image's four
phases; the seed draws the noise. So every seed quantizes the same
textures with other noise: other pixels, the same mix of colours, so that
the work and the quality do not change with the seed. The configuration
gives the pixel type.
"""

from __future__ import annotations

import torch


def _generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def make_images(traffic, input_dtype, seed, device):
    """``traffic["images"]`` distinct (N, 3) host numpy images of
    ``input_dtype`` (``uint8`` or ``float32``) made on ``device``."""
    w, h = int(traffic["width"]), int(traffic["height"])
    gen = traffic["generator"]
    tile = min(int(gen["tile"]), w, h)
    g = _generator(seed, device)
    yy, xx = torch.meshgrid(
        torch.arange(tile, dtype=torch.float32, device=device),
        torch.arange(tile, dtype=torch.float32, device=device),
        indexing="ij")
    p0, p1, p2, p3 = (float(v) for v in gen["periods"])
    a0, a1 = (float(v) for v in gen["amplitudes"])
    ramp = torch.linspace(-gen["gradient"], gen["gradient"], h,
                          dtype=torch.float32, device=device)[:, None]
    out = []
    for ph in gen["phases"][:int(traffic["images"])]:
        pat = torch.stack([
            0.5 + a0 * torch.sin(xx / p0 + ph[0]) * torch.cos(yy / p1 + ph[1]),
            0.5 + a1 * torch.cos(xx / p2 + yy / p3 + ph[2] + ph[3]),
            0.5 + gen["noise"] * torch.randn((tile, tile), generator=g,
                                             device=device),
        ], -1)
        img = pat.repeat(-(-h // tile), -(-w // tile), 1)[:h, :w]
        img[:, :, 2] += ramp
        img = img.clamp_(0.0, 1.0).reshape(-1, 3)
        if input_dtype == "uint8":
            img = torch.round(img * 255.0).to(torch.uint8)
        elif input_dtype != "float32":
            raise ValueError(f"input dtype {input_dtype!r}")
        out.append(img.cpu().numpy())
        del pat, img
    return out
