"""Where one wave of the PyTorch port spends its time on the GPU, read from
the port's own spans and counters (``dartray_tpu_torch.stats``).

    python tools/profile_torch_wave.py [--waves 4] [--res 512] [--depth 5]
                                       [--integrator path|direct|whitted|ao]
                                       [--moving] [--grad] [--pbrt FILE]
                                       [--spectrum rgb|sampled] [--rounds 3]

Builds the bench scene (with `--moving` its big sphere translates by
(0.6, 0, 0) over the shutter, so every launch is the motion kernel's), or
with ``--pbrt`` parses FILE (files it names are looked up beside it and in
``scenes/``) and takes its scene, camera, sampler, resolution, surface and
volume integrators (``manager.build_li``; igi, the photon map, the
irradiance cache and the dipole run their preprocess in the set-up),
accelerator and pixel filter (``--spectrum sampled`` parses it in the
sampled spectrum mode). A run is `--waves` waves of
renderers.sampler.render_wave of the chosen integrator (default: the path
integrator; ``ao`` takes ``--ao-samples`` probes, default 64); with
``--grad`` (path integrator, depth 5) one gradient render of `--waves`
waves, ``bench.py``'s probe loss through ``bench_torch.grad_probe``: its
forward pass, its recomputes and its backward pass. Then:

1. the set-up with the port's collector on (host spans only): the scene's
   build and upload, the pixel grid and two runs (the first loads the
   kernels);
2. the collector's cost: ``--rounds`` runs with it off and as many with it
   on (CUDA events at every span's edges), in turns, each synchronised;
3. one run with the collector on under torch.profiler with the device's
   activity alone (``benchmark/port_spans.py``).

Prints one JSON object: the set-up by top-level span and the host seconds
of its two runs; a wave's host time with the collector off and on; from
(3), a wave's time, the device's busy time and share, its kernel launches,
host and device ms by span name (the device ms between the events at the
edges of the outermost spans of the name), the device's idle by the
innermost span open at each gap, each traversal launch of a wave in order
(mode, lanes, the kernel's device ms; for a path wave the camera launch,
the five mixed launches and the last any-hit one), the share of the
sample draws the hashing kernel took, the live share of the traversal
lanes by mode and the top device kernels; with ``--grad`` the
step's device idle inside ``grad.forward``, inside ``grad.backward`` and
outside both, and its host ms inside spans marked ``recompute``. Needs one
CUDA device; writes nothing.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bench_torch  # noqa: E402
from benchmark import port_spans, tracing  # noqa: E402

from dartray_tpu_torch import cameras, samplers, stats  # noqa: E402
from dartray_tpu_torch import film as film_mod  # noqa: E402
from dartray_tpu_torch.core import spectrum  # noqa: E402
from dartray_tpu_torch.core import transform as tr  # noqa: E402
from dartray_tpu_torch.integrators import ao, direct  # noqa: E402
from dartray_tpu_torch.integrators import path as pi, whitted  # noqa: E402
from dartray_tpu_torch.ops import traverse_cuda as tc  # noqa: E402
from dartray_tpu_torch.renderers import manager  # noqa: E402
from dartray_tpu_torch.renderers import sampler as rend  # noqa: E402
from dartray_tpu_torch.scene import build as sb, types as st  # noqa: E402
from dartray_tpu_torch.scene import parser, resources  # noqa: E402

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")


def log_traversal_launches(log):
    """Make every v6 launch append its (mode, lanes) to `log`."""
    real = tc._traverse6_cuda

    def logged(bvh, oc, dc, tmin, tmax, mode, anyf, time):
        log.append((tc.MODE_NAMES[mode], oc[0].shape[0]))
        return real(bvh, oc, dc, tmin, tmax, mode, anyf, time)
    tc._traverse6_cuda = logged


def integrator(name, depth, ao_samples):
    """li_fn of the integrator `name` at `depth`."""
    if name == "path":
        ig, mod = pi.PathIntegrator(max_depth=depth), pi
    elif name == "direct":
        ig, mod = direct.DirectLightingIntegrator(max_depth=depth), direct
    elif name == "whitted":
        ig, mod = whitted.WhittedIntegrator(max_depth=depth), whitted
    else:
        ig, mod = ao.AOIntegrator(n_samples=ao_samples), ao
    return lambda s, r, d, c: mod.li(ig, s, r, d, c)


def by_span(spans, waves):
    """{name: calls, host ms and device ms a wave} over the outermost
    spans of each name, the most host time first."""
    out = {}
    for name in {s["name"] for s in spans}:
        top = port_spans.outermost(spans, name)
        d = {"calls_per_wave": len(top) / waves,
             "host_ms_per_wave": sum(s["end"] - s["start"] for s in top)
             / waves * 1e3}
        dev = [s["device_ms"] for s in top if "device_ms" in s]
        if dev:
            d["device_ms_per_wave"] = sum(dev) / waves
        out[name] = d
    return dict(sorted(out.items(), key=lambda x: -x[1]["host_ms_per_wave"]))


def setup_by_span(spans):
    """Host seconds of the set-up's top-level spans, by name."""
    acc = {}
    for s in spans:
        if s["parent"] is None:
            acc[s["name"]] = acc.get(s["name"], 0.0) + (
                s["end_ns"] - s["start_ns"]) * 1e-9
    return dict(sorted(acc.items(), key=lambda x: -x[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--waves", type=int, default=4)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--integrator", default="path",
                    choices=("path", "direct", "whitted", "ao"))
    ap.add_argument("--ao-samples", type=int, default=64)
    ap.add_argument("--moving", action="store_true")
    ap.add_argument("--grad", action="store_true")
    ap.add_argument("--pbrt", metavar="FILE")
    ap.add_argument("--spectrum", default="rgb", choices=("rgb", "sampled"))
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args()
    if a.grad and (a.integrator != "path" or a.depth != bench_torch.MAX_DEPTH
                   or a.pbrt):
        ap.error("--grad profiles bench_torch.grad_probe: the path "
                 f"integrator at depth {bench_torch.MAX_DEPTH} on the bench "
                 "scene")
    if not torch.cuda.is_available():
        print("needs one CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    filt = ("box", None)
    setup = stats.RenderStats()
    t_setup = time.perf_counter()
    with stats.collect(setup):
        if a.pbrt:
            spectrum.set_mode(a.spectrum)
            with open(a.pbrt) as f:
                job = parser.parse(f.read(), resolver=resources.Resolver(
                    [os.path.dirname(os.path.abspath(a.pbrt)), SCENES]),
                    log=lambda *_: None, device=dev)
            scene, cam = st.to_device(job.scene, dev), job.camera
            smp = job.sampler
            li = manager.build_li(job, log=lambda *_: None, device=dev)
            width, height = job.width, job.height
            filt = (job.filter_name, job.filter_params)
            a.integrator = job.surf_integrator
            a.depth = job.surf_params.find_one_int("maxdepth", 5)
        else:
            bench = sb.bench_scene()
            if a.moving:
                big = bench.meshes[0]
                big.verts_end = big.verts + np.asarray([0.6, 0.0, 0.0],
                                                       np.float32)
            scene = st.to_device(bench.build(), dev)
            cam = cameras.perspective(
                tr.look_at([0, 2.2, -5.0], [0, 0.9, 0], [0, 1, 0]), 42.0,
                a.res, a.res, device=dev)
            smp = samplers.make_sampler("lowdiscrepancy", spp=a.spp)
            li = integrator(a.integrator, a.depth, a.ao_samples)
            width = height = a.res
        film = film_mod.make_film(width, height, filter_name=filt[0],
                                  filter_params=filt[1], device=dev)
        px, py = rend.pixel_grid(width, height, device=dev)

    def wave(s):
        return rend.render_wave(
            scene, cam, smp, film, px, py,
            torch.full(px.shape, s % smp.spp, dtype=torch.int32, device=dev),
            li_fn=li, width=width, height=height, spp=smp.spp, device=dev)

    runs = iter(range(1 << 30))

    def run():
        """`a.waves` waves from the next sample indices (--grad: one
        gradient render of `a.waves` waves), synchronised; host seconds."""
        t = time.perf_counter()
        if a.grad:
            bench_torch.grad_probe(scene, dev, a.res, a.waves)
        else:
            first = next(runs) * a.waves
            for s in range(first, first + a.waves):
                wave(s)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    with torch.enable_grad() if a.grad else torch.no_grad():
        with stats.collect(setup):
            setup_runs = [run(), run()]
        setup_s = time.perf_counter() - t_setup
        off, on = [], []
        for _ in range(a.rounds):
            off.append(run())
            with stats.collect(stats.RenderStats(), events=True):
                on.append(run())
        launched = []
        log_traversal_launches(launched)
        before = dict(tc.LAUNCHES)
        rec = SimpleNamespace()
        port_spans.stretch(dev, rec, run, 1)

    w = a.waves
    port = rec.port
    spans = port["spans"]
    window = port["w1"] - port["w0"]
    dev_iv = tracing.clip(port["device"], port["w0"], port["w1"])
    busy = tracing.union_length(dev_iv)
    # every traversal kernel of the traced run, in launch order
    walks = sorted((iv for iv in dev_iv if "traverse6_kernel" in iv[0]),
                   key=lambda iv: iv[1])
    if len(walks) != len(launched):
        raise RuntimeError(f"the trace holds {len(walks)} traversal kernels "
                           f"for {len(launched)} launches")
    per_wave = len(launched) // w
    launches_of_a_wave = [
        {"mode": launched[j][0], "lanes": launched[j][1],
         "kernel_ms": sum(walks[i * per_wave + j][2]
                          - walks[i * per_wave + j][1]
                          for i in range(w)) / w * 1e3}
        for j in range(per_wave)]
    c = port["counters"]
    out = {
        "card": smi, "pbrt": a.pbrt, "integrator": a.integrator,
        "filter": filt[0], "spectrum": a.spectrum,
        "moving": a.moving, "grad": a.grad, "res": [width, height],
        "depth": a.depth, "waves": w,
        "setup_s": setup_s,
        "setup_by_span_s": setup_by_span(setup.export()["spans"]),
        "setup_runs_s": setup_runs,
        "wave_ms": statistics.median(off) / w * 1e3,
        "wave_ms_collecting": statistics.median(on) / w * 1e3,
        "collecting_over_off": statistics.median(on) / statistics.median(off),
        "wave_ms_traced": window / w * 1e3,
        "device_busy_ms_per_wave": busy / w * 1e3,
        "device_busy_share": busy / window,
        "device_launches_per_wave": len(dev_iv) / w,
        "traversal_launches_per_wave": {
            k: (v - before[k]) / w for k, v in tc.LAUNCHES.items()
            if v > before[k]},
        "traversal_launches": launches_of_a_wave,
        "traverse6_kernel_ms_per_wave": sum(b - a_ for _, a_, b in walks)
        / w * 1e3,
        "spans": by_span(spans, w),
        "idle_ms_per_wave_by_span": {
            k: v / w * 1e3 for k, v in port_spans.idle_spans(port)},
        "draws_on_kernel_pct": stats.draws_on_kernel_pct(c),
        "live_lane_pct": {
            k[6:]: 100 * c.get("lanes_live/" + k[6:], 0) / v
            for k, v in c.items() if k.startswith("lanes/") and v},
        "top_device_kernels": [
            {"name": k[:60], "device_ms_per_wave": v / w * 1e3}
            for k, v in tracing.top_by_name(dev_iv, 12)],
    }
    if a.grad:
        gaps = port_spans.stretch_gaps(port)
        idle = sum(b - a_ for a_, b in gaps)
        fwd = port_spans.overlap(
            gaps, port_spans.outermost(spans, "grad.forward"))
        bwd = port_spans.overlap(
            gaps, port_spans.outermost(spans, "grad.backward"))
        out["step"] = {
            "ms": window * 1e3, "busy_ms": busy * 1e3, "idle_ms": idle * 1e3,
            "idle_in_forward_ms": fwd * 1e3,
            "idle_in_backward_ms": bwd * 1e3,
            "idle_outside_ms": (idle - fwd - bwd) * 1e3,
            "recompute_host_ms": tracing.union_length(
                [(s["name"], s["start"], s["end"]) for s in spans
                 if s["recompute"]]) * 1e3}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
