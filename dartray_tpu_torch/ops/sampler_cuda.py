"""The sampler's hashing on the card: one launch of ``csrc/sample_hash.cu``
a draw, in native uint32 (a kernel of the port's own; the reference draws
its samples with XLA's fused uint32 ops and has no Pallas kernel for them).

Four entry points, each the same bits as its plain version, which the
callers take for CPU tensors (``samplers.py`` and ``integrators/ao.py``
route by device and sampler kind):

* ``draw`` (``samplers.sample_1d_plain`` / ``sample_2d_plain``): the
  lowdiscrepancy and stratified kinds, and the best-candidate kind at every
  dimension but the image offset's (its tile lookup stays in torch ops);
* ``camera`` (``samplers.camera_samples_plain``): image xy, lens uv and
  time of the same kinds in one launch;
* ``ao_scrambles`` (``ao.scrambles_plain``): the AO scramble pair of each
  lane, as int32 bit patterns;
* ``ao_probe`` (``core/sampling.sample02`` of one probe index): one AO
  probe's sample under each lane's pair.

The library is registered with ``traverse_cuda.register_library`` and
built and loaded by its loader (one ``nvcc`` flag set, the build directory
and its hash of ``csrc/``); each
launch goes on torch's current stream, never synchronises and allocates
nothing but its outputs here.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.sampling import M32
from . import traverse_cuda as tc

LOWDISCREPANCY, STRATIFIED = 0, 1      # the kernel's kinds (sample_hash.cu)

# launches by entry point: incremented where a kernel is launched
LAUNCHES = {"draw": 0, "camera": 0, "ao_scrambles": 0, "ao_probe": 0}


def bind(lib):
    """Declare the launchers' C signatures on the loaded library."""
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    sampler = [i, u, u, u, u, i, i]     # kind, spp, seed, nx, ny, jitter, bits
    for name, args in (
            ("sample_hash_draw_launch", [p] * 5 + [i, i, i] + sampler[1:]),
            ("sample_hash_camera_launch", [p] * 8 + [i] + sampler),
            ("sample_hash_ao_scrambles_launch", [p] * 5 + [i]),
            ("sample_hash_ao_probe_launch", [p] * 4 + [i, u, i])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = i, args + [p]


tc.register_library("sample_hash", bind)


def _lanes(px, py, s):
    """px, py, s broadcast to one shape as contiguous int32 planes (an int64
    lane keeps its low 32 bits, the u32 the hashing reads)."""
    dev = px.device
    for x, name in ((px, "px"), (py, "py"), (s, "s_idx")):
        if (not torch.is_tensor(x) or x.device != dev or dev.type != "cuda"
                or x.dtype not in (torch.int32, torch.int64)):
            raise ValueError(f"sample hashing: {name} must be an int32 or "
                             f"int64 tensor on the CUDA device of px, got "
                             f"{getattr(x, 'dtype', type(x))} on "
                             f"{getattr(x, 'device', None)}")
    px, py, s = torch.broadcast_tensors(px, py, s)
    planes = [x.reshape(-1).to(torch.int32).contiguous() for x in (px, py, s)]
    n = planes[0].numel()
    if n >= 2 ** 31:
        raise ValueError(f"sample hashing: {n} lanes, at most 2**31 - 1")
    return dev, px.shape, n, planes


def _launch(entry, fn, dev, *args):
    lib = tc.load_kernel("sample_hash")
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")
    LAUNCHES[entry] += 1


def _outputs(n, k, dev, dtype=torch.float32):
    return [torch.empty(n, dtype=dtype, device=dev) for _ in range(k)]


def _ptr(x):
    return x.data_ptr()


def _sampler_args(spp, seed, nx, ny, jitter, n_bits):
    return spp & M32, seed & M32, nx, ny, int(bool(jitter)), n_bits


def draw(px, py, s, dim: int, *, two_d: bool, kind: int, spp: int,
         seed: int, nx: int = 1, ny: int = 1, jitter: bool = True,
         n_bits: int = 1):
    """One draw of `kind` (``LOWDISCREPANCY`` or ``STRATIFIED``) at
    dimension `dim` for every lane: ``(x, y)`` with `two_d`, else ``(x,)``,
    float32 tensors of the lanes' broadcast shape."""
    dev, shape, n, planes = _lanes(px, py, s)
    outs = _outputs(n, 2 if two_d else 1, dev)
    if n:
        _launch("draw", "sample_hash_draw_launch", dev, *map(_ptr, planes),
                _ptr(outs[0]), _ptr(outs[1]) if two_d else None, n, kind,
                dim, *_sampler_args(spp, seed, nx, ny, jitter, n_bits))
    return tuple(o.view(shape) for o in outs)


def camera(px, py, s, *, kind: int, spp: int, seed: int, nx: int = 1,
           ny: int = 1, jitter: bool = True, n_bits: int = 1):
    """The camera draws of every lane in one launch: ``(image_x, image_y,
    lens_u, lens_v, time_u)``, the image sample the pixel plus its offset."""
    dev, shape, n, planes = _lanes(px, py, s)
    outs = _outputs(n, 5, dev)
    if n:
        _launch("camera", "sample_hash_camera_launch", dev,
                *map(_ptr, planes), *map(_ptr, outs), n, kind,
                *_sampler_args(spp, seed, nx, ny, jitter, n_bits))
    return tuple(o.view(shape) for o in outs)


def ao_scrambles(px, py, s):
    """The AO scramble pair of every lane: two int32 tensors holding the
    u32 bit patterns ``ao.scrambles_plain`` computes."""
    dev, shape, n, planes = _lanes(px, py, s)
    outs = _outputs(n, 2, dev, torch.int32)
    if n:
        _launch("ao_scrambles", "sample_hash_ao_scrambles_launch", dev,
                *map(_ptr, planes), *map(_ptr, outs), n)
    return tuple(o.view(shape) for o in outs)


def ao_probe(scr, probe: int, n_bits: int):
    """AO probe `probe`'s (0,2)-sequence sample under each lane's scramble
    pair `scr` (``ao_scrambles``' output): ``(u, v)`` float32."""
    sx, sy = scr
    dev = sx.device
    for x in scr:
        if (x.device != dev or dev.type != "cuda" or x.dtype != torch.int32
                or x.shape != sx.shape or not x.is_contiguous()):
            raise ValueError("sample hashing: the AO scramble pair must be "
                             "two contiguous int32 tensors of one shape on "
                             "one CUDA device")
    n = sx.numel()
    outs = _outputs(n, 2, dev)
    if n:
        _launch("ao_probe", "sample_hash_ao_probe_launch", dev, _ptr(sx),
                _ptr(sy), *map(_ptr, outs), n, probe & M32, n_bits)
    return tuple(o.view(sx.shape) for o in outs)
