"""Image film: XYZ + weight accumulation (counterpart of the JAX reference's
``film.py``).

The film is a device (H, W, 4) accumulator [X, Y, Z, weightSum]; a whole
wavefront of samples is deposited with one scatter-add (``index_put_`` with
accumulate). ``add_samples`` updates ``film.pixels`` IN PLACE and returns the
same film: the wave loop threads one buffer through all waves instead of
allocating a new image per wave.

Ported: the box filter at its default width (the footprint is exactly the
owning pixel). Triangle, gaussian, mitchell and sinc filters, wider boxes,
the Metropolis splat buffer and checkpoints raise ``NotImplementedError`` or
are absent (ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import device as device_mod
from .core import math as vm
from .core import spectrum as spec

FILTER_TABLE_SIZE = 16

FILTER_DEFAULTS = {
    "box": {"xwidth": 0.5, "ywidth": 0.5},
}


def filter_table(name: str, params=None):
    """Precompute the 16x16 filter table: (table numpy f32, xwidth, ywidth)."""
    if name not in FILTER_DEFAULTS:
        raise NotImplementedError(
            f"filter {name!r}: only 'box' is ported (ROADMAP Queue 1)")
    p = dict(FILTER_DEFAULTS[name])
    if params:
        p.update(params)
    table = np.ones((FILTER_TABLE_SIZE, FILTER_TABLE_SIZE), np.float32)
    return table, float(p["xwidth"]), float(p["ywidth"])


@dataclasses.dataclass
class Film:
    """Device film state. x0/y0: crop-window offset of this film's pixel
    (0,0) in full-image raster coords."""
    pixels: Any     # (H, W, 4) [X, Y, Z, weight]
    ftable: Any     # (16, 16)
    width: int
    height: int
    xwidth: float
    ywidth: float
    x0: int
    y0: int


def make_film(width, height, filter_name="box", filter_params=None,
              x0=0, y0=0, device=device_mod.DEFAULT) -> Film:
    dev = device_mod.resolve(device)
    table, xw, yw = filter_table(filter_name, filter_params)
    if xw > 0.5 or yw > 0.5:
        raise NotImplementedError(
            "filter footprints wider than one pixel are not ported "
            "(ROADMAP Queue 1)")
    return Film(pixels=torch.zeros((height, width, 4), dtype=torch.float32,
                                   device=dev),
                ftable=torch.from_numpy(table).to(dev), width=width,
                height=height, xwidth=xw, ywidth=yw, x0=x0, y0=y0)


def add_samples(film: Film, image_xy, L_rgb, mask=None) -> Film:
    """Deposit a wavefront of radiance samples (in place).

    image_xy: V2 (or (R, 2)) continuous raster coords; L: V3 (or (R, 3))
    RGB. NaN / negative / infinite samples are zeroed and carry no weight.
    With the box filter of half-width <= 0.5 the footprint is exactly the
    owning pixel: one scatter-add."""
    xy = vm.from_arr2(image_xy)
    L = vm.from_arr(L_rgb)
    finite = spec.all_finite(L)
    lum = spec.luminance(L)
    ok = finite & (lum > -1e-5) & torch.isfinite(lum)
    if mask is not None:
        ok = ok & mask
    L = vm.where3(ok, L, 0.0)
    w_ok = ok.to(torch.float32)
    xyz = spec.to_xyz(L)
    ix = torch.floor(xy.x - film.x0).to(torch.int64)
    iy = torch.floor(xy.y - film.y0).to(torch.int64)
    in_img = ((ix >= 0) & (ix < film.width) & (iy >= 0) & (iy < film.height))
    w = torch.where(in_img, 1.0, 0.0) * w_ok
    contrib = torch.stack([xyz.x * w, xyz.y * w, xyz.z * w, w], dim=-1)
    film.pixels.index_put_((iy.clamp(0, film.height - 1),
                            ix.clamp(0, film.width - 1)), contrib,
                           accumulate=True)
    return film


def to_rgb(film: Film):
    """Resolve to (H, W, 3) linear RGB: XYZ/weightSum -> RGB, clamped >= 0."""
    w = film.pixels[..., 3:4]
    xyz = film.pixels[..., :3] / w.clamp_min(1e-12)
    rgb = spec.xyz_to_rgb(torch.where(w > 0, xyz, 0.0))
    return rgb.clamp_min(0.0)
