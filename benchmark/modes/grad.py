"""The gradient mode: an inverse-rendering fit. One object holds the scene,
the albedo table ``materials.kd`` and a plain Adam state; each step renders
through ``grad.render_loss_grad`` at the step's own sampler seed, takes
mean((img - target)**2) and updates the albedos.

The benchmark makes the starting albedos and the target from the seed.
Set-up drives the fit through its first ``checked_steps`` steps, which the
reference follows from those same inputs; the last step of the window is
checked too, the reference following it from the program's albedos and
Adam state as that step found them.
"""
import statistics
import time

import numpy as np
import torch

from benchmark import harness, registry, scenes
from benchmark.reference import render as ref_render
from benchmark.reference import sampling as ref_smp

GRAD = True
SYNC_UNITS = True       # a fit reads each step's loss before the next


def adam_update(x, g, state, hp):
    """One plain Adam step (``state`` gets new tensors, none is written in
    place); returns the new x, clamped to [0, 1] as an albedo."""
    state["t"] += 1
    b1, b2 = hp["beta1"], hp["beta2"]
    state["m"] = b1 * state["m"] + (1 - b1) * g
    state["v"] = b2 * state["v"] + (1 - b2) * g * g
    m_hat = state["m"] / (1 - b1 ** state["t"])
    v_hat = state["v"] / (1 - b2 ** state["t"])
    return (x - hp["lr"] * m_hat / (torch.sqrt(v_hat) + hp["eps"])).clamp(
        0.0, 1.0)


def step_seed(seed, k):
    return (int(seed) + 7919 * k) & 0xFFFFFFFF


def inputs(cfg, traffic, seed, dev):
    """The inputs the benchmark makes from the seed and hands to both sides:
    the starting albedo table (the matte materials of nonzero albedo drawn
    uniformly in ``albedo_range``, the others as configured) and the target
    image (uniform in ``target_range``, made on the device)."""
    rng = np.random.default_rng(seed)
    lo, hi = traffic["albedo_range"]
    rows = []
    for row in cfg["materials"].values():
        kd = np.asarray(row.get("kd", (0, 0, 0)), np.float32)
        if row["type"] == "matte" and kd.any():
            kd = rng.uniform(lo, hi, 3).astype(np.float32)
        rows.append(kd)
    kd0 = torch.as_tensor(np.stack(rows), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) & 0xFFFFFFFFFFFF)
    t0, t1 = traffic["target_range"]
    target = torch.rand((traffic["height"], traffic["width"], 3),
                        generator=g, device=dev) * (t1 - t0) + t0
    return kd0, target


class Cell:
    def __init__(self, cfg, traffic, seed, dev, rec, bench):
        from dartray_tpu_torch import cameras, grad
        from dartray_tpu_torch.core import transform as tr
        from dartray_tpu_torch.scene import types as st
        self.grad, self.dev, self.traffic, self.seed = grad, dev, traffic, seed
        self.W, self.H = traffic["width"], traffic["height"]
        t0 = time.perf_counter()
        host = scenes.builder_scene(cfg)
        self.scene = st.to_device(host, dev)
        harness.sync(dev)
        rec.spans["scene_build"] = time.perf_counter() - t0
        harness.load_kernels(dev, rec)
        c = cfg["camera"]
        self.cam = cameras.perspective(
            tr.look_at(c["eye"], c["look"], c["up"]), c["fov"], self.W,
            self.H, device=dev)
        self.li = registry.load("integrators", traffic["integrator"],
                                bench).program(traffic["integrator_params"])
        self.kd, self.target = inputs(cfg, traffic, seed, dev)
        self.kd0 = self.kd.clone()
        _, self.inject = grad.select(self.scene, [traffic["params"]])
        self.adam = {"t": 0, "m": torch.zeros_like(self.kd),
                     "v": torch.zeros_like(self.kd)}
        self.update = adam_update
        target = self.target
        self.loss_of = lambda img: ((img - target) ** 2).mean()
        self.steps = 0
        self.history = []      # (loss, kd after the step) of checked steps
        self.first_grad = None
        self.images = []       # the checked first steps' images
        self.last = None       # the latest step: its start, image and loss

    def unit(self):
        """One step. What the step started from is kept by reference (the
        update makes new tensors), so the kept state costs no copy."""
        from dartray_tpu_torch import samplers
        start = {"kd": self.kd, "t": self.adam["t"], "m": self.adam["m"],
                 "v": self.adam["v"], "step": self.steps}
        smp = samplers.make_sampler(self.traffic["sampler"]["kind"],
                                    spp=self.traffic["spp"],
                                    seed=step_seed(self.seed, self.steps))
        loss, grads = self.grad.render_loss_grad(
            self.scene, self.cam, smp, self.li, self.W, self.H,
            {self.traffic["params"]: self.kd}, self.inject, self._observe,
            spp=self.traffic["spp"], device=self.dev)
        self.kd = self.update(self.kd, grads[self.traffic["params"]],
                              self.adam, self.traffic["adam"])
        self.steps += 1
        self.last = dict(start, loss=loss, image=self._img)
        return loss

    def _observe(self, img):
        """The loss the fit minimises; the image is kept (no copy) for the
        check to read."""
        self._img = img.detach()
        return self.loss_of(img)

    def warm_up(self):
        """The checked first steps of the fit, which the reference follows
        from the benchmark's own inputs."""
        b1 = self.traffic["adam"]["beta1"]
        for k in range(self.traffic["checked_steps"]):
            loss = self.unit()
            if k == 0:
                # the first gradient as the optimizer holds it
                self.first_grad = (self.adam["m"] / (1 - b1)).detach().cpu()
            self.history.append((float(loss), self.kd.detach().cpu()))
            self.images.append(self._img.cpu())

    def samples_per_unit(self):
        return self.W * self.H * self.traffic["spp"]

    def answers(self, seed):
        """The checked first steps, and the window's last step: the state it
        started from, its loss and image, and the state it left."""
        b1 = self.traffic["adam"]["beta1"]
        w = self.last
        window = {"step": w["step"], "kd": w["kd"].detach().cpu(),
                  "state": {"t": w["t"], "m": w["m"].detach().cpu(),
                            "v": w["v"].detach().cpu()},
                  "loss": float(w["loss"]), "image": w["image"].cpu(),
                  "kd_after": self.kd.detach().cpu(),
                  # the step's gradient as the optimizer took it in
                  "grad": ((self.adam["m"] - b1 * w["m"]) / (1 - b1)).cpu()}
        return {"losses": [h[0] for h in self.history],
                "images": self.images,
                "first_grad": self.first_grad,
                "kd0": self.kd0.cpu(),
                "kd_after": self.history[-1][1],
                "target": self.target.cpu(),
                "window": window}


# --- the check ---------------------------------------------------------------

def _ref_step(sc, cam, est, traffic, seed, k, kd, state, target, dtype):
    smp = ref_smp.Sampler(traffic["sampler"]["kind"], traffic["spp"],
                          step_seed(seed, k))
    loss, g, img = ref_render.loss_grad(
        sc, cam, smp, est, traffic["width"], traffic["height"],
        traffic["spp"], kd, target, dtype)
    g = g.float()
    return float(loss), g, img.cpu(), adam_update(kd, g, state,
                                                  traffic["adam"])


def reference(cfg, traffic, seed, ans, dev, dtype, bench):
    """The reference's fit through the checked first steps from the same
    albedos and target, and its step from the state the window's last step
    started from."""
    sc = harness.reference_scene(cfg, dev, dtype)
    cam = harness.reference_camera(cfg, traffic, dev, dtype)
    est = registry.load("integrators", traffic["integrator"],
                        bench).reference(traffic["integrator_params"])
    kd = ans["kd0"].to(dev)
    target = ans["target"].to(dev).to(dtype)
    state = {"t": 0, "m": torch.zeros_like(kd), "v": torch.zeros_like(kd)}
    losses, images, first = [], [], None
    for k in range(traffic["checked_steps"]):
        loss, _, img, kd = _ref_step(sc, cam, est, traffic, seed, k, kd,
                                     state, target, dtype)
        images.append(img)
        if k == 0:
            first = (state["m"] / (1 - traffic["adam"]["beta1"])).cpu()
        losses.append(loss)
    w = ans["window"]
    wstate = {"t": w["state"]["t"], "m": w["state"]["m"].to(dev),
              "v": w["state"]["v"].to(dev)}
    wloss, wg, wimg, wkd = _ref_step(sc, cam, est, traffic, seed, w["step"],
                                     w["kd"].to(dev), wstate, target, dtype)
    return {"losses": losses, "images": images, "first_grad": first,
            "kd_after": kd.cpu(),
            "window": dict(w, loss=wloss, image=wimg, grad=wg.cpu(),
                           kd_after=wkd.cpu())}


def _leaf_gaps(prog, ref, keep):
    """Worst |‖prog leaf‖ - ‖ref leaf‖| over max(‖ref leaf‖, median leaf
    norm) among the kept leaves (rows of the albedo table)."""
    pn = prog.double().norm(dim=-1)
    rn = ref.double().norm(dim=-1)
    den = torch.clamp(rn, min=statistics.median(rn.tolist()))
    gap = (pn - rn).abs() / den.clamp_min(1e-30)
    return float(gap[keep].max()) if keep.any() else 0.0


def _numbers(prog, ref):
    """Each the worst over the checked steps (the first ones and the
    window's last). img_rel_err_median: a step's median pixel of its image
    (``harness.pixel_numbers``); loss_gap: the relative gap of a step's
    loss; grad_gap: the worst leaf's gap of the norm of the first step's
    and of the window step's gradient; change_gap: the worst leaf's gap of
    the norm of the albedos' change over the first steps and over the
    window's step. A leaf counts where the reference's first gradient is at
    least a thousandth of the median leaf's."""
    pw, rw = prog["window"], ref["window"]
    lp = np.asarray(prog["losses"] + [pw["loss"]], np.float64)
    lr = np.asarray(ref["losses"] + [rw["loss"]], np.float64)
    loss_gap = float(np.max(np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)))
    rn = ref["first_grad"].double().norm(dim=-1)
    keep = rn >= 1e-3 * statistics.median(rn.tolist())
    img_med = max(harness.pixel_numbers(p, r)["rel_err_median"]
                  for p, r in zip(prog["images"] + [pw["image"]],
                                  ref["images"] + [rw["image"]]))
    grad_gap = max(_leaf_gaps(prog["first_grad"], ref["first_grad"], keep),
                   _leaf_gaps(pw["grad"], rw["grad"], keep))
    change_gap = max(
        _leaf_gaps(prog["kd_after"] - prog["kd0"],
                   ref["kd_after"] - prog["kd0"], keep),
        _leaf_gaps(pw["kd_after"] - pw["kd"], rw["kd_after"] - pw["kd"],
                   keep))
    return {"img_rel_err_median": img_med, "loss_gap": loss_gap,
            "grad_gap": grad_gap, "change_gap": change_gap}


def numbers(cfg, traffic, seed, ans, dev, bench, control=None):
    """The numbers of the program's fit (or, under control="bf16", of the
    reference's in bfloat16 from the same starts) against the reference."""
    ref = reference(cfg, traffic, seed, ans, dev, torch.float32, bench)
    prog = ans
    if control:
        prog = reference(cfg, traffic, seed, ans, dev, torch.bfloat16,
                         bench)
        prog["kd0"] = ans["kd0"]
    return _numbers(prog, ref)


# --- the traced stretches ----------------------------------------------------

def trace(obj, traffic, dev, rec):
    """After the window, two steps: one traced with the device's activity
    alone (busy and idle time, the top kernels); one traced with the
    host's operators too, whose backward pass (torch.autograd.grad inside
    grad.render_loss_grad, the checkpoints' recomputes included) runs in a
    synchronised range: it attributes device time to the backward pass and
    names the idle gaps."""
    rec.trace = dict(harness.profile_device(dev, obj.unit), units=1)
    saved = torch.autograd.grad
    try:
        torch.autograd.grad = harness.synced_range(dev, "backward", saved)
        split = harness.profile_host(dev, obj.unit)
    finally:
        torch.autograd.grad = saved
    rec.split = dict(split, units=1, range="backward")


# --- planted faults ----------------------------------------------------------

def fault_unchanged(obj):
    """The update leaves the albedos (and Adam) as they were."""
    obj.update = lambda x, g, state, hp: x


def fault_half(obj):
    """Half the rows of the fitted image left out of the loss, the mean
    taken over the rest."""
    target = obj.target
    obj.loss_of = lambda img: ((img - target)[: img.shape[0] // 2]
                               ** 2).mean()


FAULTS = {"unchanged": fault_unchanged, "half": fault_half,
          "altered": harness.fault_altered}
