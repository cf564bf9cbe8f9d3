"""The render mode over a moving scene: waves of
``renderers.sampler.render_wave`` as ``modes/render.py`` runs them, over a
configuration whose shapes may carry ``motion`` (``translate_end``, the
shape's translation at shutter close, and ``shutter``). The scene goes to
the port through ``SceneBuilder.add_mesh(verts_end=...)`` and the camera
takes the shutter, so every camera ray carries its sample's time and the
traversal takes the kernel's motion instantiation.

The check recomputes the sampled pixels with the moving reference
(``reference/motion.py``); a traced run adds, after the render mode's
stretches, one with the port's collector on (``port_spans.stretch``), as
``modes/render_spans.py`` does. The record's ``mode`` is "render", so the
render cells' metrics read it as one, and ``wave_lanes`` is the lanes a
wave traces as the traffic states them ((1 + nsamples) x W x H: the camera
wave and one probe wave a probe), whatever the port counts.

Faults: the render mode's, and ``frozen``: every camera ray at shutter
open, so the moving shape renders where it starts.
"""
import os
import sys
import time

import torch

from benchmark import harness, port_spans, registry, scenes
from benchmark.reference import motion as ref_motion
from benchmark.reference import render as ref_render
from benchmark.reference import sampling as ref_smp

render = registry.load("modes", "render",
                       os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))

GRAD = render.GRAD
SYNC_UNITS = render.SYNC_UNITS


def shutter_of(cfg):
    """The shutter of the configuration's moving shapes ((0, 1) where none
    moves); every moving shape must state the same one."""
    got = {tuple(s["motion"]["shutter"]) for s in cfg["shapes"]
           if "motion" in s}
    if len(got) > 1:
        raise ValueError(f"moving shapes with different shutters: {got}")
    return tuple(float(x) for x in (got.pop() if got else (0.0, 1.0)))


def verts_end(cfg, bench):
    """Each mesh's vertices at shutter close (None for a static shape): the
    shape made again at its ``translate_end``, from the same arrays."""
    return [scenes.make_shape(dict(s, translate=s["motion"]["translate_end"]),
                              bench).verts if "motion" in s else None
            for s in cfg["shapes"]]


def builder_scene(cfg, bench):
    """The configuration through the port's SceneBuilder, each moving
    shape with its shutter-close vertices: a host scene."""
    from dartray_tpu_torch import materials as mat_mod
    from dartray_tpu_torch.scene import build as sb
    from dartray_tpu_torch.scene import mesh as mesh_mod
    b = sb.SceneBuilder()
    b.shutter = shutter_of(cfg)
    ids = {name: b.add_material(scenes.port_material(mat_mod, row))
           for name, row in cfg["materials"].items()}
    for m, ve in zip(cfg["meshes"], verts_end(cfg, bench)):
        b.add_mesh(mesh_mod.make_mesh(m.verts, m.faces, m.normals, m.uvs),
                   ids[m.material], area_light_L=m.light_L, verts_end=ve)
    return b.build()


class Cell(render.Cell):
    def __init__(self, cfg, traffic, seed, dev, rec, bench):
        from dartray_tpu_torch import cameras, samplers
        from dartray_tpu_torch import film as film_mod
        from dartray_tpu_torch.core import transform as tr
        from dartray_tpu_torch.renderers import sampler as rend
        from dartray_tpu_torch.scene import types as st
        if cfg["front_door"] != "builder":
            raise ValueError("the moving render mode takes the \"builder\" "
                             "front door")
        rec.mode = "render"
        self.film_mod, self.rend = film_mod, rend
        self.dev = dev
        self.W, self.H = traffic["width"], traffic["height"]
        self.traffic = traffic
        t0 = time.perf_counter()
        host = builder_scene(cfg, bench)
        c = cfg["camera"]
        open_, close = shutter_of(cfg)
        self.cam = cameras.perspective(
            tr.look_at(c["eye"], c["look"], c["up"]), c["fov"], self.W,
            self.H, shutter_open=open_, shutter_close=close, device=dev)
        self.li = registry.load("integrators", traffic["integrator"],
                                bench).program(traffic["integrator_params"])
        self.filter = (traffic["filter"], None)
        self.scene = st.to_device(host, dev)
        harness.sync(dev)
        rec.spans["scene_build"] = time.perf_counter() - t0
        harness.load_kernels(dev, rec)
        self.smp = samplers.make_sampler(traffic["sampler"]["kind"],
                                         spp=traffic["spp"], seed=seed)
        self.spp = self.smp.spp
        self.px, self.py = rend.pixel_grid(self.W, self.H, device=dev)
        self.film = self._new_film()
        self.s = 0


# --- the check ---------------------------------------------------------------

def reference_pixels(cfg, traffic, seed, ans, dev, dtype, bench):
    sc = ref_motion.Scene(cfg["meshes"], verts_end(cfg, bench),
                          cfg["materials"], shutter_of(cfg), dev, dtype)
    cam = harness.reference_camera(cfg, traffic, dev, dtype)
    smp = ref_smp.Sampler(traffic["sampler"]["kind"], traffic["spp"], seed)
    est = registry.load("integrators", traffic["integrator"],
                        bench).reference(traffic["integrator_params"])
    return ref_render.pixel_values(
        sc, cam, smp, est, torch.as_tensor(ans["px"], device=dev),
        torch.as_tensor(ans["py"], device=dev), ans["n"], dtype)


def numbers(cfg, traffic, seed, ans, dev, bench, control=None):
    """``harness.pixel_numbers`` of the program's pixels (or, under
    control="bf16", the moving reference's in bfloat16) against the moving
    reference in float32, TF32 off."""
    with ref_motion.no_tf32():
        ref = reference_pixels(cfg, traffic, seed, ans, dev, torch.float32,
                               bench)
        prog = ans["rgb"]
        if control:
            prog = reference_pixels(cfg, traffic, seed, ans, dev,
                                    torch.bfloat16, bench)
    return harness.pixel_numbers(prog, ref)


# --- the traced stretches ----------------------------------------------------

MOTION_KERNEL = "traverse6_kernel<true>"
STATIC_KERNEL = "traverse6_kernel<false>"


def trace(obj, traffic, dev, rec):
    """The render mode's stretches, then one with the port's collector on;
    to standard error: the device's idle by innermost port span, and a
    wave's motion lanes and traversal kernels by instantiation."""
    render.trace(obj, traffic, dev, rec)
    rec.wave_lanes = ((1 + traffic["integrator_params"]["nsamples"])
                      * traffic["width"] * traffic["height"])
    port_spans.stretch(dev, rec, obj.unit, render.PROFILED_WAVES)
    units = rec.trace["units"]
    kern = {k: sum(1 for n, _, _ in rec.trace["device"] if k in n) / units
            for k in (MOTION_KERNEL, STATIC_KERNEL)}
    print(f"traversal kernels a wave: {kern}", file=sys.stderr, flush=True)
    port = getattr(rec, "port", None)
    if port:
        lanes = {k: v / port["units"] for k, v in port["counters"].items()
                 if k.startswith("lanes_motion/")}
        print(f"motion lanes a wave: {lanes}", file=sys.stderr, flush=True)
        print("idle_spans (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in port_spans.idle_spans(port)),
            file=sys.stderr, flush=True)


# --- planted faults ----------------------------------------------------------

def fault_frozen(obj):
    """Every camera ray (and so every probe) at shutter open."""
    li = obj.li
    open_ = float(obj.cam.shutter_open)
    obj.li = lambda s, r, d, c: li(
        s, r._replace(time=torch.full_like(r.time, open_)), d, c)


FAULTS = dict(render.FAULTS, frozen=fault_frozen)
