"""The render mode: waves of ``renderers.sampler.render_wave`` over the whole
film, one sample index a wave, back to back, as ``renderers.sampler.render``
drives them; a frame that reaches its samples is followed by a new film.

The mix names the integrator (``integrators/<name>.py``), the sampler, the
film and ``check_pixels``: the pixels, drawn from the seed, whose every
sample in the film at the window's close the reference recomputes.
"""
import time

import numpy as np
import torch

from benchmark import harness, registry, scenes
from benchmark.reference import render as ref_render
from benchmark.reference import sampling as ref_smp

GRAD = False            # the window runs under torch.no_grad()
SYNC_UNITS = False      # waves go back to back, as render() issues them
PROFILED_WAVES = 2      # waves in the device-only traced stretch


class Cell:
    def __init__(self, cfg, traffic, seed, dev, rec, bench):
        from dartray_tpu_torch import cameras, samplers
        from dartray_tpu_torch import film as film_mod
        from dartray_tpu_torch.core import transform as tr
        from dartray_tpu_torch.renderers import manager
        from dartray_tpu_torch.renderers import sampler as rend
        from dartray_tpu_torch.scene import parser, resources
        from dartray_tpu_torch.scene import types as st
        self.film_mod, self.rend = film_mod, rend
        self.dev = dev
        self.W, self.H = traffic["width"], traffic["height"]
        self.traffic = traffic
        t0 = time.perf_counter()
        if cfg["front_door"] == "pbrt":
            job = parser.parse(scenes.pbrt_text(cfg, traffic),
                               resolver=resources.Resolver([bench]),
                               log=rec.log, device=dev)
            host, self.cam = job.scene, job.camera
            self.li = manager.build_li(job, log=rec.log, device=dev)
            self.filter = (job.filter_name, job.filter_params)
            if (job.width, job.height) != (self.W, self.H):
                raise RuntimeError("the parsed film differs from the mix's")
        else:
            host = scenes.builder_scene(cfg)
            c = cfg["camera"]
            self.cam = cameras.perspective(
                tr.look_at(c["eye"], c["look"], c["up"]), c["fov"], self.W,
                self.H, device=dev)
            self.li = registry.load("integrators", traffic["integrator"],
                                    bench).program(
                                        traffic["integrator_params"])
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
        self.s = 0             # samples of every pixel in the current film

    def _new_film(self):
        return self.film_mod.make_film(self.W, self.H,
                                       filter_name=self.filter[0],
                                       filter_params=self.filter[1],
                                       device=self.dev)

    def unit(self):
        if self.s == self.spp:
            self.film, self.s = self._new_film(), 0
        s_idx = torch.full(self.px.shape, self.s, dtype=torch.int32,
                           device=self.dev)
        self.film = self.rend.render_wave(
            self.scene, self.cam, self.smp, self.film, self.px, self.py,
            s_idx, li_fn=self.li, width=self.W, height=self.H,
            spp=self.spp, device=self.dev)
        self.s += 1

    def warm_up(self):
        for _ in range(self.traffic.get("warmup_waves", 2)):
            self.unit()

    def samples_per_unit(self):
        return self.W * self.H

    def answers(self, seed):
        """RGB of sampled pixels of the current film and the samples it
        holds."""
        k = min(self.traffic["check_pixels"], self.W * self.H)
        rng = np.random.default_rng(seed)
        flat = np.sort(rng.choice(self.W * self.H, size=k, replace=False))
        xs, ys = flat % self.W, flat // self.W
        img = self.film_mod.to_rgb(self.film)
        vals = img[torch.as_tensor(ys, device=self.dev),
                   torch.as_tensor(xs, device=self.dev)].float().cpu()
        return {"px": xs, "py": ys, "rgb": vals, "n": self.s}


# --- the check ---------------------------------------------------------------

def reference_pixels(cfg, traffic, seed, ans, dev, dtype, bench):
    sc = harness.reference_scene(cfg, dev, dtype)
    cam = harness.reference_camera(cfg, traffic, dev, dtype)
    smp = ref_smp.Sampler(traffic["sampler"]["kind"], traffic["spp"], seed)
    est = registry.load("integrators", traffic["integrator"],
                        bench).reference(traffic["integrator_params"])
    return ref_render.pixel_values(
        sc, cam, smp, est, torch.as_tensor(ans["px"], device=dev),
        torch.as_tensor(ans["py"], device=dev), ans["n"], dtype)


def numbers(cfg, traffic, seed, ans, dev, bench, control=None):
    """``harness.pixel_numbers`` of the program's pixels (or, under
    control="bf16", the reference's in bfloat16) against the reference."""
    ref = reference_pixels(cfg, traffic, seed, ans, dev, torch.float32,
                           bench)
    prog = ans["rgb"]
    if control:
        prog = reference_pixels(cfg, traffic, seed, ans, dev,
                                torch.bfloat16, bench)
    return harness.pixel_numbers(prog, ref)


# --- the traced stretches ----------------------------------------------------

def trace(obj, traffic, dev, rec):
    """After the window: waves traced with the device's activity alone
    (busy and idle time, kernels, the top kernels); one wave traced with
    the host's operators too, whose traversal calls run in synchronised
    ranges: it attributes device time to traversal and names the idle
    gaps."""
    from dartray_tpu_torch.scene import types as st

    def waves():
        for _ in range(PROFILED_WAVES):
            obj.unit()
    rec.trace = dict(harness.profile_device(dev, waves),
                     units=PROFILED_WAVES)
    names = ("intersect", "intersect_pair", "intersect_p")
    saved = {k: getattr(st, k) for k in names}
    q0 = st.QUERIES["rays"]
    try:
        for k in names:
            setattr(st, k, harness.synced_range(dev, "traversal", saved[k]))
        split = harness.profile_host(dev, obj.unit)
    finally:
        for k, fn in saved.items():
            setattr(st, k, fn)
    rec.split = dict(split, lanes=st.QUERIES["rays"] - q0, units=1,
                     range="traversal")


# --- planted faults ----------------------------------------------------------

def fault_unchanged(obj):
    """Each wave hands back the film it was given: it deposits nothing."""
    obj.rend = harness.Shim(obj.rend, "render_wave",
                            lambda scene, cam, smp, film, *a, **k: film)


def fault_half(obj):
    """Half of each wave's lanes left out."""
    real = obj.rend.render_wave

    def half(scene, cam, smp, film, px, py, s_idx, **k):
        n = px.shape[0] // 2
        return real(scene, cam, smp, film, px[:n], py[:n], s_idx[:n], **k)
    obj.rend = harness.Shim(obj.rend, "render_wave", half)


FAULTS = {"unchanged": fault_unchanged, "half": fault_half,
          "altered": harness.fault_altered}
