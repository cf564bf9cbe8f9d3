"""Image film: XYZ + weight accumulation with filter-table weights
(counterpart of the JAX reference's ``film.py``).

The film is a device (H, W, 4) accumulator [X, Y, Z, weightSum] plus an
(H, W, 3) XYZ splat buffer (Metropolis). ``add_samples`` updates
``film.pixels`` IN PLACE and returns the same film: the wave loop threads
one buffer through all waves instead of allocating a new image per wave.
``add_samples_functional`` does the same arithmetic out of place and
returns a new film, as the reference's ``add_samples`` does: autograd needs
it, since a tensor it saved for the backward pass must not change, and a
checkpointed wave re-runs its deposit on the film it was given.

Filters: box, triangle, gaussian, mitchell and sinc, each read from a 16x16
table of its weights. A box of half-width <= 0.5 deposits a sample into the
pixel it lies in; any wider filter deposits into every pixel of its
footprint: the ext_x x ext_y taps of a whole wave go in ONE scatter of
R * ext_x * ext_y rows. ``save_checkpoint`` / ``load_checkpoint`` keep a
film and the next sample index in an ``.npz`` file.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from . import device as device_mod
from .core import math as vm
from .core import spectrum as spec

FILTER_TABLE_SIZE = 16

# --- filters (host numpy) ---------------------------------------------------

def filter_eval(name: str, params, x, y):
    """The filter kernel at x / y (numpy, in the filter's own units)."""
    xw, yw = params["xwidth"], params["ywidth"]
    ax, ay = np.abs(x), np.abs(y)
    if name == "box":
        return np.ones_like(x)
    if name == "triangle":
        return np.maximum(xw - ax, 0.0) * np.maximum(yw - ay, 0.0)
    if name == "gaussian":
        a = params.get("alpha", 2.0)
        ex = np.exp(-a * xw * xw)
        ey = np.exp(-a * yw * yw)
        gx = np.maximum(np.exp(-a * x * x) - ex, 0.0)
        gy = np.maximum(np.exp(-a * y * y) - ey, 0.0)
        return gx * gy
    if name == "mitchell":
        b = params.get("B", 1.0 / 3.0)
        c = params.get("C", 1.0 / 3.0)

        def m1d(t):
            t = np.abs(2.0 * t)
            return np.where(
                t > 1,
                ((-b - 6 * c) * t ** 3 + (6 * b + 30 * c) * t ** 2
                 + (-12 * b - 48 * c) * t + (8 * b + 24 * c)) * (1.0 / 6.0),
                ((12 - 9 * b - 6 * c) * t ** 3
                 + (-18 + 12 * b + 6 * c) * t ** 2
                 + (6 - 2 * b)) * (1.0 / 6.0))
        return m1d(x / xw) * m1d(y / yw)
    if name == "sinc":
        tau = params.get("tau", 3.0)

        def s1d(t, w):
            t = np.abs(t / w)
            return np.where(
                t < 1e-5, 1.0,
                np.where(t > 1.0, 0.0,
                         (np.sin(np.pi * t * tau)
                          / np.maximum(np.pi * t * tau, 1e-9))
                         * (np.sin(np.pi * t) / np.maximum(np.pi * t, 1e-9))))
        return s1d(x, xw) * s1d(y, yw)
    raise ValueError(f"unknown filter {name}")


FILTER_DEFAULTS = {
    "box": {"xwidth": 0.5, "ywidth": 0.5},
    "triangle": {"xwidth": 2.0, "ywidth": 2.0},
    "gaussian": {"xwidth": 2.0, "ywidth": 2.0, "alpha": 2.0},
    "mitchell": {"xwidth": 2.0, "ywidth": 2.0, "B": 1 / 3, "C": 1 / 3},
    "sinc": {"xwidth": 4.0, "ywidth": 4.0, "tau": 3.0},
}


def filter_table(name: str, params=None):
    """The 16x16 table of filter weights at the cell centres of the
    positive quadrant: (table numpy f32, xwidth, ywidth)."""
    p = dict(FILTER_DEFAULTS[name])
    if params:
        p.update(params)
    xw, yw = p["xwidth"], p["ywidth"]
    fx = (np.arange(FILTER_TABLE_SIZE) + 0.5) / FILTER_TABLE_SIZE * xw
    fy = (np.arange(FILTER_TABLE_SIZE) + 0.5) / FILTER_TABLE_SIZE * yw
    gx, gy = np.meshgrid(fx, fy, indexing="ij")
    table = filter_eval(name, p, gx, gy).astype(np.float32)
    return table, float(xw), float(yw)


@dataclasses.dataclass
class Film:
    """Device film state. x0/y0: crop-window offset of this film's pixel
    (0,0) in full-image raster coords."""
    pixels: Any     # (H, W, 4) [X, Y, Z, weight]
    splat: Any      # (H, W, 3) XYZ splat (Metropolis)
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
    return Film(pixels=torch.zeros((height, width, 4), dtype=torch.float32,
                                   device=dev),
                splat=torch.zeros((height, width, 3), dtype=torch.float32,
                                  device=dev),
                ftable=torch.from_numpy(table).to(dev), width=width,
                height=height, xwidth=xw, ywidth=yw, x0=x0, y0=y0)


def _deposit(film: Film, image_xy, L_rgb, mask):
    """The scatter of one wavefront: ((row, column) pixel indices, (N, 4)
    rows [X, Y, Z, weight]). NaN / negative / infinite samples are zeroed and
    carry no weight. A box of half-width <= 0.5 gives each sample the pixel
    it lies in (N = R); a wider filter gives it every pixel of its footprint
    [dx - xwidth, dx + xwidth] x [dy - ywidth, dy + ywidth], weighted from
    the table (N = R * ext_x * ext_y, taps outside the support or the image
    weigh 0)."""
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
    if film.xwidth <= 0.5 and film.ywidth <= 0.5:
        ix = torch.floor(xy.x - film.x0).to(torch.int64)
        iy = torch.floor(xy.y - film.y0).to(torch.int64)
        w = torch.where((ix >= 0) & (ix < film.width) & (iy >= 0)
                        & (iy < film.height), 1.0, 0.0) * w_ok
    else:
        dx = xy.x - 0.5 - film.x0
        dy = xy.y - 0.5 - film.y0
        ext_x = int(np.floor(2.0 * film.xwidth)) + 1
        ext_y = int(np.floor(2.0 * film.ywidth)) + 1
        dev = dx.device
        # taps along a leading axis: (ext_y * ext_x, 1) offsets against
        # (1, R) samples, flattened tap-major
        ox = torch.arange(ext_x, dtype=torch.int32, device=dev).repeat(ext_y)
        oy = torch.arange(ext_y, dtype=torch.int32,
                          device=dev).repeat_interleave(ext_x)
        ix = torch.ceil(dx - film.xwidth).to(torch.int32)[None] + ox[:, None]
        iy = torch.ceil(dy - film.ywidth).to(torch.int32)[None] + oy[:, None]
        adx = torch.abs(ix.to(torch.float32) - dx)
        ady = torch.abs(iy.to(torch.float32) - dy)
        tx = (adx * (1.0 / film.xwidth) * FILTER_TABLE_SIZE).to(
            torch.int32).clamp_max(FILTER_TABLE_SIZE - 1)
        ty = (ady * (1.0 / film.ywidth) * FILTER_TABLE_SIZE).to(
            torch.int32).clamp_max(FILTER_TABLE_SIZE - 1)
        fw = film.ftable[tx.long(), ty.long()]
        keep = ((adx <= film.xwidth) & (ady <= film.ywidth) & (ix >= 0)
                & (ix < film.width) & (iy >= 0) & (iy < film.height))
        w = (torch.where(keep, fw, 0.0) * w_ok).reshape(-1)
        ix, iy = ix.reshape(-1).to(torch.int64), iy.reshape(-1).to(torch.int64)
        xyz = vm.V3(*(c.repeat(ext_x * ext_y) for c in xyz))
    contrib = torch.stack([xyz.x * w, xyz.y * w, xyz.z * w, w], dim=-1)
    return ((iy.clamp(0, film.height - 1), ix.clamp(0, film.width - 1)),
            contrib)


def add_samples(film: Film, image_xy, L_rgb, mask=None) -> Film:
    """Deposit a wavefront of radiance samples (in place).

    image_xy: V2 (or (R, 2)) continuous raster coords; L: V3 (or (R, 3))
    RGB. One scatter-add into ``film.pixels``; the same film is returned."""
    idx, contrib = _deposit(film, image_xy, L_rgb, mask)
    film.pixels.index_put_(idx, contrib, accumulate=True)
    return film


def add_samples_functional(film: Film, image_xy, L_rgb, mask=None) -> Film:
    """``add_samples`` out of place: a new film whose pixels are the old
    ones plus this wavefront's scatter; `film` is left as it was."""
    idx, contrib = _deposit(film, image_xy, L_rgb, mask)
    return dataclasses.replace(
        film, pixels=film.pixels.index_put(idx, contrib, accumulate=True))


def splat(film: Film, image_xy, L_rgb, mask=None) -> Film:
    """Unweighted accumulation into the splat buffer (Metropolis), in
    place: a sample lands in the pixel it lies in; non-finite samples and
    samples outside the image add nothing."""
    xy = vm.from_arr2(image_xy)
    L = vm.from_arr(L_rgb)
    finite = spec.all_finite(L)
    if mask is not None:
        finite = finite & mask
    xyz = spec.to_xyz(vm.where3(finite, L, 0.0))
    fx = xy.x - film.x0
    fy = xy.y - film.y0
    ix = fx.to(torch.int64).clamp(0, film.width - 1)
    iy = fy.to(torch.int64).clamp(0, film.height - 1)
    inb = (fx >= 0) & (fx < film.width) & (fy >= 0) & (fy < film.height)
    xyz = vm.where3(inb, xyz, 0.0)
    film.splat.index_put_((iy, ix), torch.stack([xyz.x, xyz.y, xyz.z], dim=-1),
                          accumulate=True)
    return film


def save_checkpoint(path, film: Film, next_s: int):
    """Film + the next sample index: with samples keyed by (pixel, sample
    index, dimension), this is a complete render checkpoint. Written to a
    temporary file and renamed, so a killed writer leaves the last one."""
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, pixels=film.pixels.detach().cpu().numpy(),
             splat=film.splat.detach().cpu().numpy(),
             next_s=np.asarray(next_s, np.int64),
             meta=np.asarray([film.width, film.height, film.x0, film.y0]))
    os.replace(tmp, str(path))


def load_checkpoint(path, film: Film):
    """(film, next_s) saved by ``save_checkpoint``; `film` supplies the
    filter table and meta and must have the saved resolution."""
    d = np.load(str(path))
    meta = d["meta"]
    if tuple(meta[:2]) != (film.width, film.height):
        raise ValueError(f"checkpoint resolution {tuple(meta[:2])} != "
                         f"film ({film.width}, {film.height})")
    dev = film.pixels.device
    film = dataclasses.replace(film,
                               pixels=torch.from_numpy(d["pixels"]).to(dev),
                               splat=torch.from_numpy(d["splat"]).to(dev))
    return film, int(d["next_s"])


def to_rgb(film: Film, splat_scale=0.0):
    """Resolve to (H, W, 3) linear RGB: XYZ / weightSum -> RGB clamped >= 0,
    plus splat_scale times the splat buffer's RGB clamped >= 0."""
    w = film.pixels[..., 3:4]
    xyz = film.pixels[..., :3] / w.clamp_min(1e-12)
    rgb = spec.xyz_to_rgb(torch.where(w > 0, xyz, 0.0)).clamp_min(0.0)
    if splat_scale:
        rgb = rgb + spec.xyz_to_rgb(film.splat).clamp_min(0.0) * splat_scale
    return rgb
