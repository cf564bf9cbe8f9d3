"""Band-sharded rendering: tiles x samples over ranks (counterpart of the JAX
reference's ``parallel/mesh.py``).

A mesh of n_tiles x n_spp cells splits the image into n_tiles row bands and
the sample indices into n_spp chunks. Cell (t, k) renders band t's pixels
with chunk k's samples into a band-local film of hb + 2 * margin rows, where
the margin rows catch filter footprints that spill across the band's edges.
The scene is replicated. The film's accumulators (XYZ, weight, splat) are
additive, so the bands and chunks compose by summing.

Two branches, as in the reference:

- one process (no ``torch.distributed`` process group): the process renders
  every cell in turn on its device, sums a band's chunks in chunk order and
  composes the bands on the host (``compose_bands``);
- ranks (``init_distributed`` brought a process group up): each rank renders
  its one cell, ``all_reduce``s the band over its ``spp`` subgroup, places it
  at row t * hb of a film of n_tiles * hb + 2 * margin rows and
  ``all_reduce``s that over the whole world; every rank trims the result
  (``_unshift``) and returns the image. That second sum runs over the
  ``spp`` axis too, so the composed film's sums and weights are n_spp times
  the one-process ones and the image (their ratio) is the same (known
  behaviour ai of ROADMAP.md, kept as the reference has it).

Samples are keyed by (pixel, sample index, dimension), never by cell, so the
image equals ``renderers.sampler.render``'s: bit for bit with the box filter
and one chunk (disjoint bands, one sample a pixel a wave), within float32
summation order otherwise.

A mesh takes exactly as many ranks as it has cells. The reference takes the
first n_tiles * n_spp devices and asserts only that there are not fewer; a
rank outside the mesh would still have to join both ``all_reduce``s here,
so a larger world raises too (known behaviour aj).

Ranks on one host that share a card (the H100 machine has one) talk over
gloo, which NCCL's one-communicator-a-device rule forbids; ranks with a card
each talk over NCCL; CPU ranks over gloo. Gloo's reductions go through host
memory.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import cameras as cam_mod
from .. import device as device_mod
from .. import film as film_mod
from .. import samplers as smp_mod
from ..core import math as vm
from ..renderers import sampler as rend
from ..scene import types as st


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=device_mod.DEFAULT) -> bool:
    """Bring up this process's rank (``torch.distributed.init_process_group``).

    coordinator: an init method (``tcp://host:port``, ``file:///path``, or
    ``host:port``); without one, ``MASTER_ADDR`` / ``MASTER_PORT`` as
    ``torchrun`` sets them (``env://``). Neither given: no-op, returns False.
    num_processes / process_id default to ``WORLD_SIZE`` / ``RANK``.

    device: "cuda" (the default; raises without a card) or "cpu". A CUDA
    rank takes card ``LOCAL_RANK`` (default: its rank) modulo the cards
    there are, and becomes the current device; the backend is NCCL when the
    host has a card for each of its ``LOCAL_WORLD_SIZE`` ranks (default: the
    world), gloo when ranks share a card, when the device names its card
    explicitly, and on the CPU. Returns True."""
    if coordinator is None:
        if "MASTER_ADDR" not in os.environ or "MASTER_PORT" not in os.environ:
            return False
        coordinator = "env://"
    elif "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    world = (int(os.environ.get("WORLD_SIZE", "1")) if num_processes is None
             else num_processes)
    rank = int(os.environ.get("RANK", "0")) if process_id is None \
        else process_id
    dev = device_mod.resolve(device)
    backend = "gloo"
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if dev.index is None:
            local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
            dev = torch.device("cuda", local_rank % n_cards)
            if n_cards >= local_world:
                backend = "nccl"
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=world, rank=rank)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """n_tiles x n_spp cells; cell (t, k) is rank t * n_spp + k.
    device_mesh: the ranks' ``DeviceMesh`` (dims "tiles", "spp"), or None
    when one process holds every cell."""
    shape: dict
    device_mesh: Any = None

    def coordinate(self):
        """(t, k) of this rank's cell."""
        t, k = self.device_mesh.get_coordinate()
        return t, k


def make_device_mesh(n_tiles: int, n_spp: int) -> Mesh:
    """A mesh of n_tiles x n_spp cells: over the ranks when a process group
    is up (their number must equal the cells'), else in this process."""
    shape = {"tiles": n_tiles, "spp": n_spp}
    if not dist.is_initialized():
        return Mesh(shape)
    world = dist.get_world_size()
    if world != n_tiles * n_spp:
        raise ValueError(f"a {n_tiles} x {n_spp} mesh needs exactly "
                         f"{n_tiles * n_spp} ranks, the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(shape, init_device_mesh(kind, (n_tiles, n_spp),
                                        mesh_dim_names=("tiles", "spp")))


def band_pixel_grid(width, height, n_tiles, device=device_mod.DEFAULT):
    """Row-band pixel decomposition: band t owns rows [t*hb, (t+1)*hb),
    hb = ceil(height / n_tiles), each band Morton-ordered
    (``renderers.sampler.pixel_grid``) and padded to hb * width lanes with
    dead ones (px = 0, py = -1); a band past the image is all padding.
    Returns int32 (px, py) on `device` and hb."""
    dev = device_mod.resolve(device)
    hb = -(-height // n_tiles)
    pxs, pys = [], []
    for t in range(n_tiles):
        y0 = t * hb
        h_t = min(hb, height - y0)
        if h_t > 0:
            px, py = rend.pixel_grid(width, h_t, y0=y0, device="cpu")
            px, py = px.numpy(), py.numpy()
        else:
            px = py = np.zeros((0,), np.int32)
        pad = hb * width - px.shape[0]
        pxs.append(np.concatenate([px, np.zeros(pad, np.int32)]))
        pys.append(np.concatenate([py, np.full(pad, -1, np.int32)]))
    return (torch.from_numpy(np.concatenate(pxs)).to(dev),
            torch.from_numpy(np.concatenate(pys)).to(dev), hb)


def _render_cell(scene, camera, sampler, li_fn, width, height, px, py,
                 samples, y_shift, film):
    """Deposit the waves of sample indices `samples` (-1: a padded chunk
    slot) over one band's lanes into its band film. Padded lanes and
    samples are traced like live ones and masked at the deposit; the
    deposit's y is shifted into band rows in float32."""
    live = py >= 0
    diff_scale = 1.0 / np.sqrt(max(sampler.spp, 1))
    for s in samples:
        s_idx = torch.full(px.shape, max(s, 0), dtype=torch.int32,
                           device=px.device)
        cs = smp_mod.camera_samples(sampler, px, py, s_idx)
        rays, diffs, weight = cam_mod.generate_rays(camera, cs, width,
                                                    height, diff_scale)
        sctx = {"sampler": sampler, "px": px, "py": py, "s_idx": s_idx}
        L = li_fn(scene, rays, diffs, sctx) * weight
        xy = vm.V2(cs.image_xy.x, cs.image_xy.y - float(y_shift))
        film_mod.add_samples(film, xy, L, mask=live & (s >= 0))
    return film


def _all_reduce(x, group=None):
    """Sum `x` over `group`'s ranks; gloo takes a host copy of a CUDA
    tensor."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        y = x.cpu()
        dist.all_reduce(y, group=group)
        return y.to(x.device)
    dist.all_reduce(x, group=group)
    return x


def sharded_film(scene, camera, sampler, li_fn: Callable, width: int,
                 height: int, mesh: Mesh, filter_name: str = "box",
                 filter_params=None, device=device_mod.DEFAULT):
    """The composed film of a sharded render: (pixels (H, W, 4) [X, Y, Z,
    weight], splat (H, W, 3)) as float32 numpy. Over ranks, every rank
    returns it, n_spp times the one-process sums (known behaviour ai)."""
    dev = device_mod.resolve(device)
    n_tiles, n_spp = mesh.shape["tiles"], mesh.shape["spp"]
    spp = sampler.spp
    px, py, hb = band_pixel_grid(width, height, n_tiles, device=dev)
    _, _, yw = film_mod.filter_table(filter_name, filter_params)
    margin = int(np.ceil(max(yw - 0.5, 0.0)))
    band_h = hb + 2 * margin
    s_all = list(range(spp)) + [-1] * ((-spp) % n_spp)
    local_spp = len(s_all) // n_spp

    def cell(t, k):
        lanes = slice(t * hb * width, (t + 1) * hb * width)
        film = film_mod.make_film(width, band_h, filter_name=filter_name,
                                  filter_params=filter_params, device=dev)
        film = _render_cell(scene, camera, sampler, li_fn, width, height,
                            px[lanes], py[lanes],
                            s_all[k * local_spp:(k + 1) * local_spp],
                            t * hb - margin, film)
        return torch.cat([film.pixels, film.splat], dim=-1)

    with torch.no_grad():
        scene = st.to_device(scene, dev)
        if mesh.device_mesh is None:
            bands = []
            for t in range(n_tiles):
                band = cell(t, 0)
                for k in range(1, n_spp):
                    band = band + cell(t, k)
                bands.append(band.cpu().numpy())
            comp = compose_bands(np.stack(bands), height, width, hb, margin)
        else:
            t, k = mesh.coordinate()
            band = _all_reduce(cell(t, k), mesh.device_mesh.get_group("spp"))
            full = torch.zeros((n_tiles * hb + 2 * margin, width, 7),
                               dtype=torch.float32, device=dev)
            full[t * hb:t * hb + band_h] = band
            comp = _unshift(_all_reduce(full).cpu().numpy(), height, width,
                            hb, margin)
    return comp[..., :4], comp[..., 4:]


def render_sharded(scene, camera, sampler, li_fn: Callable, width: int,
                   height: int, mesh: Mesh, filter_name: str = "box",
                   filter_params=None, device=device_mod.DEFAULT):
    """Full sharded render -> (H, W, 3) linear RGB as numpy, on every
    rank."""
    dev = device_mod.resolve(device)
    pixels, splat = sharded_film(scene, camera, sampler, li_fn, width,
                                 height, mesh, filter_name=filter_name,
                                 filter_params=filter_params, device=dev)
    film = film_mod.make_film(width, height, filter_name=filter_name,
                              filter_params=filter_params, device=dev)
    film = dataclasses.replace(film, pixels=torch.from_numpy(pixels).to(dev),
                               splat=torch.from_numpy(splat).to(dev))
    with torch.no_grad():
        return film_mod.to_rgb(film).cpu().numpy()


def compose_bands(bands: np.ndarray, height, width, hb, margin):
    """Add each band's rows into the full film: band t's rows are global
    rows [t*hb - margin, t*hb + hb + margin); rows that overlap add (the
    accumulators are linear); rows outside the image are dropped."""
    n_tiles = bands.shape[0]
    out = np.zeros((height, width) + bands.shape[3:], np.float32)
    for t in range(n_tiles):
        y0 = t * hb - margin
        for i in range(bands.shape[1]):
            y = y0 + i
            if 0 <= y < height:
                out[y] += bands[t, i]
    return out


def _unshift(arr, height, width, hb, margin):
    """Trim the ranks' composed film: bands were placed at row t*hb with
    their leading margin rows, so global row y sits at row y + margin."""
    out = np.zeros((height, width) + arr.shape[2:], np.float32)
    src = np.asarray(arr)
    for y in range(height):
        out[y] = src[y + margin] if y + margin < src.shape[0] else 0.0
    return out
