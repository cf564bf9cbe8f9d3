"""Where one wave of the PyTorch port spends its time on the GPU.

    python tools/profile_torch_wave.py [--waves 4] [--res 512] [--depth 5]
                                       [--integrator path|direct|whitted|ao]
                                       [--moving]

Builds the bench scene (with `--moving` its big sphere translates by
(0.6, 0, 0) over the shutter, so every launch is the motion kernel's), warms
up, then runs `--waves` waves of
renderers.sampler.render_wave of the chosen integrator (default: the path
integrator; ``ao`` takes ``--ao-samples`` probes, default 64) under
torch.profiler with the port's stages
wrapped in named ranges (wrapped from here, the package carries no
instrumentation). Prints one JSON object: wave time on the host clock, the
device's busy share, kernel launches per wave, time by stage, the top
device kernels, and `traversal_launches`: mode, lanes and the kernel's own
time from the trace for each traversal launch of a wave in order (for a path
wave the camera launch, the five mixed launches and the last any-hit one),
the mean over the waves. Needs one CUDA device; writes nothing.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from dartray_tpu_torch import bsdf, cameras, film as film_mod  # noqa: E402
from dartray_tpu_torch import materials, samplers  # noqa: E402
from dartray_tpu_torch.core import transform as tr  # noqa: E402
from dartray_tpu_torch.integrators import ao, common, direct  # noqa: E402
from dartray_tpu_torch.integrators import path as pi, whitted  # noqa: E402
from dartray_tpu_torch import lights  # noqa: E402
from dartray_tpu_torch.ops import traverse_cuda as tc  # noqa: E402
from dartray_tpu_torch.renderers import sampler as rend  # noqa: E402
from dartray_tpu_torch.scene import build as sb, types as st  # noqa: E402

STAGES = [
    (samplers, "sample_1d"), (samplers, "sample_2d"),
    (cameras, "generate_rays"), (st, "interaction"),
    (materials, "eval_params"), (bsdf, "make_frame"), (bsdf, "sample_f"),
    (common, "nee_prepare"), (common, "emitter_hit_mis"),
    (common, "estimate_direct"), (lights, "sample_li"), (bsdf, "f"),
    (tc, "sort_key_i32"), (tc, "_sorted_launch"), (tc, "traverse6"),
    (tc, "finish_hits_rows"), (film_mod, "add_samples"),
]


def wrap_stages():
    for mod, name in STAGES:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _tag=f"stage:{name}", **k):
            with record_function(_tag):
                return _fn(*a, **k)
        setattr(mod, name, wrapped)


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
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs one CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    bench = sb.bench_scene()
    if a.moving:
        big = bench.meshes[0]
        big.verts_end = big.verts + np.asarray([0.6, 0.0, 0.0], np.float32)
    scene = st.to_device(bench.build(), dev)
    cam = cameras.perspective(
        tr.look_at([0, 2.2, -5.0], [0, 0.9, 0], [0, 1, 0]), 42.0, a.res,
        a.res, device=dev)
    smp = samplers.make_sampler("lowdiscrepancy", spp=a.spp)
    li = integrator(a.integrator, a.depth, a.ao_samples)
    film = film_mod.make_film(a.res, a.res, device=dev)
    px, py = rend.pixel_grid(a.res, a.res, device=dev)

    def wave(s):
        return rend.render_wave(
            scene, cam, smp, film, px, py,
            torch.full(px.shape, s, dtype=torch.int32, device=dev),
            li_fn=li, width=a.res, height=a.res, spp=smp.spp, device=dev)

    with torch.no_grad():
        for s in range(2):
            wave(s)
        torch.cuda.synchronize()
        t0 = time.time()
        for s in range(2, 2 + a.waves):
            wave(s)
        torch.cuda.synchronize()
        plain_wave_ms = (time.time() - t0) / a.waves * 1e3

        launched = []
        log_traversal_launches(launched)
        wrap_stages()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for s in range(2 + a.waves, 2 + 2 * a.waves):
                wave(s)
            torch.cuda.synchronize()
            traced_wave_ms = (time.time() - t0) / a.waves * 1e3

    ka = prof.key_averages()
    # every traversal kernel of the traced waves, in launch order
    walks = sorted((e for e in prof.events()
                    if "traverse6_kernel" in e.name and e.cpu_time_total == 0
                    and e.self_device_time_total > 0),
                   key=lambda e: e.time_range.start)
    if len(walks) != len(launched):
        raise RuntimeError(f"the trace holds {len(walks)} traversal kernels "
                           f"for {len(launched)} launches")
    per_wave = len(launched) // a.waves
    launches_of_a_wave = [
        {"mode": launched[j][0], "lanes": launched[j][1],
         "kernel_ms": sum(walks[w * per_wave + j].self_device_time_total
                          for w in range(a.waves)) / a.waves / 1e3}
        for j in range(per_wave)]
    # an entry with host time is a CPU op or a named range; an entry with
    # device time and no host time lies on the card's own timeline. Device
    # kernels are the latter (the CPU ops that launched them repeat their
    # kernels' device time); a named range also leaves a twin there, which
    # spans the gaps between its kernels and is left out.
    on_host = lambda e: e.cpu_time_total > 0
    kernels = [e for e in ka if not on_host(e)
               and e.self_device_time_total > 0
               and not e.key.startswith("stage:")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    # stages: host time of the range, device time of the kernels it launched
    stages = sorted(
        ({"stage": e.key[6:], "calls_per_wave": e.count / a.waves,
          "host_ms_per_wave": e.cpu_time_total / a.waves / 1e3,
          "device_ms_per_wave": e.device_time_total / a.waves / 1e3}
         for e in ka if e.key.startswith("stage:") and on_host(e)),
        key=lambda d: -d["host_ms_per_wave"])
    self_dev = lambda e: e.self_device_time_total
    top = sorted(kernels, key=lambda e: -self_dev(e))[:12]
    print(json.dumps({
        "card": smi, "integrator": a.integrator, "moving": a.moving,
        "res": a.res,
        "depth": a.depth, "waves": a.waves,
        "traversal_launches_per_wave": {
            k: v / (2 + 2 * a.waves) for k, v in tc.LAUNCHES.items() if v},
        "traversal_launches": launches_of_a_wave,
        "wave_ms": plain_wave_ms, "wave_ms_traced": traced_wave_ms,
        "device_busy_ms_per_wave": busy_us / a.waves / 1e3,
        "device_busy_share": busy_us / 1e3 / a.waves / traced_wave_ms,
        "device_launches_per_wave": launches / a.waves,
        # launched through ctypes, so no CPU op carries its device time
        "traverse6_kernel_ms_per_wave": sum(
            e.self_device_time_total for e in kernels
            if "traverse6_kernel" in e.key) / a.waves / 1e3,
        "stages": stages,
        "top_device_kernels": [
            {"name": e.key[:60], "calls_per_wave": e.count / a.waves,
             "device_ms_per_wave": self_dev(e) / a.waves / 1e3} for e in top],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
