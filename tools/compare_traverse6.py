"""Time other builds of the v6 walk against the packaged one, in ONE process.

    python tools/compare_traverse6.py --other parent=DIR [--other NAME=DIR,-DX=1 ...]
                                      [--real] [--out FILE]

`DIR/traverse6.cu` (with the headers beside it) is built with the package's
own ``NVCC_FLAGS`` plus the flags after the comma, all builds started
together, and loaded beside the packaged library; its launchers must have
the packaged interface. To compare with the parent commit:

    mkdir -p dartray_tpu_torch/_build/parent
    for f in traverse6.cu ray_tests.cuh; do
      git show HEAD~1:dartray_tpu_torch/csrc/$f > dartray_tpu_torch/_build/parent/$f
    done
    python tools/compare_traverse6.py --other parent=dartray_tpu_torch/_build/parent

Every build is driven through ``traverse_cuda.traverse6`` (the wrapper, host
work included) on the six tensor sets of ``chip_smoke.wave_shapes`` over the
bench scene: camera wave closest, sorted incoherent rays any-hit, sorted
mixed wave, each static and moving; with `--real` also on the ray tensors of
the seven launches of one path-integrator wave over each scene (camera, five
mixed bounces, last any-hit). For each set the raw (t, prim) of every
build is held against ``traverse6_plain`` on the same device tensors
(`equal`), and the builds are timed in turns, forward then backward (A B C,
C B A), by CUDA events: median of 7 launches after 2 warm-ups in
each turn (`ms_forward`, `ms_backward`); then 20 launches queued back to
back (`ms_queued`, device ms a launch) beside the host's time to enqueue one
(`host_ms`). Prints one JSON line per row and build, and ptxas' registers,
shared memory and spills per build. Needs one CUDA device and `nvcc`.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dartray_tpu_torch import film as film_mod  # noqa: E402
from dartray_tpu_torch.core import math as vm  # noqa: E402
from dartray_tpu_torch.integrators import path as pi  # noqa: E402
from dartray_tpu_torch.ops import traverse_cuda as tc  # noqa: E402
from dartray_tpu_torch.renderers import sampler as rend  # noqa: E402
from dartray_tpu_torch.scene import build as sb, types as st  # noqa: E402


def build_others(specs):
    """{name: "DIR[,flag...]"} -> {name: (library, ptxas report)}."""
    out_dir = os.path.join(tc.BUILD_DIR, "compare")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, spec in specs.items():
        src_dir, *flags = spec.split(",")
        so = os.path.join(out_dir, f"lib{name}.so")
        cmd = [tc._find_nvcc(), *tc.NVCC_FLAGS, *flags, "-o", so,
               os.path.join(src_dir, "traverse6.cu")]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        lib = ctypes.CDLL(so)
        tc._bind("traverse6", lib)
        libs[name] = (lib, log)
    return libs


def resources(log):
    """ptxas' report -> [{registers, smem, stack, spill_stores}] per kernel
    (the motion instantiation is the one with ``ILb1E`` in its name)."""
    out = {}
    kern = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kern = "motion" if "ILb1E" in m.group(1) else "static"
            out[kern] = {}
        if kern is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores")):
            m = re.search(pat, line)
            if m:
                out[kern][key] = int(m.group(1))
    return out


def queued_and_host_ms(run, launches=20):
    """(device ms a launch with `launches` of them queued back to back, host
    ms the wrapper takes to enqueue one). Where the first is not above the
    second, the host and not the kernel sets the pace."""
    run()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(launches):
        run()
    b.record()
    host = (time.perf_counter() - t0) / launches * 1e3
    torch.cuda.synchronize()
    return a.elapsed_time(b) / launches, host


def path_wave_launches(scene, dev):
    """The ray tensors of every traversal launch of one path-integrator wave
    (the third, at chip_smoke's width and depth) over `scene`, as the
    wrapper got them: [(rays, keywords of traverse6)] in launch order."""
    ig = pi.PathIntegrator(max_depth=cs.MAX_DEPTH)
    cam, smp, px, py, _ = cs.camera_wave(dev)
    film = film_mod.make_film(cs.WIDTH, cs.HEIGHT, device=dev)
    real, seen = tc._traverse6_cuda, []

    def keep(bvh, oc, dc, tmin, tmax, mode, anyf, time):
        g = lambda x: None if x is None else x.clone()
        rays = vm.Rays(vm.V3(*map(g, oc)), vm.V3(*map(g, dc)), g(tmin),
                       g(tmax), g(time))
        seen.append((rays, {"any_hit": mode == tc.MODE_ANY, "anyf": g(anyf)}))
        return real(bvh, oc, dc, tmin, tmax, mode, anyf, time)

    with torch.no_grad():
        for s in range(3):
            if s == 2:
                tc._traverse6_cuda = keep
            try:
                film = rend.render_wave(
                    scene, cam, smp, film, px, py,
                    torch.full(px.shape, s, dtype=torch.int32, device=dev),
                    li_fn=lambda sc, r, d, c: pi.li(ig, sc, r, d, c),
                    width=cs.WIDTH, height=cs.HEIGHT, spp=smp.spp, device=dev)
            finally:
                tc._traverse6_cuda = real
    return seen


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR[,nvcc flag...]")
    ap.add_argument("--real", action="store_true",
                    help="also the launches of one path wave, static (rows "
                    "1w0..) and moving (2w0..)")
    ap.add_argument("--out", help="also write the JSON lines here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs one CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    lines = []

    def say(**kw):
        lines.append(json.dumps(kw))
        print(lines[-1], flush=True)

    say(card=cs.nvidia_smi_line(), torch=torch.__version__)
    others = build_others(dict(s.split("=", 1) for s in a.other))
    packaged = tc.load_kernel("traverse6")
    builds = {"packaged": packaged, **{k: v[0] for k, v in others.items()}}
    say(resources={"packaged": resources(tc.BUILD_LOG.get("traverse6", "")),
                   **{k: resources(v[1]) for k, v in others.items()}})

    scene = st.to_device(sb.bench_scene().build(), dev)
    mb = sb.bench_scene()
    mb.meshes[0].verts_end = mb.meshes[0].verts + np.asarray(
        cs.MOTION_SHIFT, np.float32)
    moving = st.to_device(mb.build(), dev)
    _, _, _, _, cam_rays = cs.camera_wave(dev)
    rows = []
    for tag, geom in (("1", scene.geometry), ("2", moving.geometry)):
        cam, inc, mixed, af = cs.wave_shapes(geom, dev, cam_rays)
        rows += [(tag + "a", geom, cam, dict(any_hit=False)),
                 (tag + "b", geom, inc, dict(any_hit=True)),
                 (tag + "c", geom, mixed, dict(anyf=af))]
    if a.real:
        rows += [(f"{tag}w{j}", sc.geometry, rays, kw)
                 for tag, sc in (("1", scene), ("2", moving))
                 for j, (rays, kw) in enumerate(path_wave_launches(sc, dev))]
    bad = []
    for row, geom, rays, kw in rows:
        if geom.has_motion:
            kw["time"] = rays.time
        args = (geom.packed, rays.o, rays.d, rays.tmin, rays.tmax)
        want = tc.traverse6_plain(*args, **kw)
        run = lambda: tc.traverse6(*args, **kw)
        equal, ms, queued = {}, {name: [] for name in builds}, {}
        for name, lib in builds.items():
            tc._libs["traverse6"] = lib
            tc.reset_overflow(dev)
            got = run()
            torch.cuda.synchronize()
            equal[name] = (all(torch.equal(g, w) for g, w in zip(got, want))
                           and int(tc.overflow_flag(dev).item()) == 0)
            if not equal[name]:
                bad.append((row, name))
        for order in (list(builds), list(builds)[::-1]):
            for name in order:
                tc._libs["traverse6"] = builds[name]
                ms[name].append(cs.time_ms(run, repeats=7, warmup=2))
        for name in builds:
            tc._libs["traverse6"] = builds[name]
            queued[name] = queued_and_host_ms(run)
        tc._libs["traverse6"] = packaged
        for name in builds:
            say(row=row, lanes=rays.n, build=name, equal=equal[name],
                ms_forward=ms[name][0], ms_backward=ms[name][1],
                ms_queued=queued[name][0], host_ms=queued[name][1],
                vs_first_other=(None if not others else min(ms[name]) / min(
                    ms[next(iter(others))])))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    if bad:
        print(f"differs from traverse6_plain: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
