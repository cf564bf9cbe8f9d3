"""Time other builds of a traversal kernel against the packaged one, in ONE
process.

    python tools/compare_traverse6.py [--kernel traverse6|traverse1|traverse2|
                                               traverse3|traverse4|traverse5|
                                               traverse7 ...]
                                      --other parent=DIR [--other NAME=DIR,-DX=1 ...]
                                      [--real] [--out FILE]

For each `--kernel` (default traverse6; may be repeated), `DIR/<kernel>.cu`
(with the headers beside it) is built with the package's own ``NVCC_FLAGS``
plus the flags after the comma, all builds started together, and loaded
beside the packaged library; its launcher must have the packaged interface.
A DIR without that source takes no part for that kernel. To compare with the
parent commit (every source and header of ``csrc/``, so one directory serves
every kernel):

    mkdir -p dartray_tpu_torch/_build/parent
    git archive HEAD~1 dartray_tpu_torch/csrc | tar -x --strip-components=2 \
        -C dartray_tpu_torch/_build/parent
    python tools/compare_traverse6.py --kernel traverse1 --kernel traverse3 \
        --other parent=dartray_tpu_torch/_build/parent

traverse6: every build is driven through ``traverse_cuda.traverse6`` (the
wrapper, host work included) on the six tensor sets of
``chip_smoke.wave_shapes`` over the bench scene: camera wave closest, sorted
incoherent rays any-hit, sorted mixed wave, each static and moving (rows 1a-c,
2a-c); with `--real` also on the ray tensors of the seven launches of one
path-integrator wave over each scene (camera, five mixed bounces, last
any-hit; rows 1w0.., 2w0..). Raw (t, prim) are held against
``traverse6_plain``.

The binary-tree kernels (traverse1 .. traverse4, rows 5, 8, 7, 6 of PERF.md's
kernel table): through their wrappers on the static scene's camera wave,
closest (row "a"), and the sorted incoherent rays, any-hit (row "b"); with
`--real` also on the ray tensors of the 18 launches of one direct-lighting
wave routed to that kernel (rows 5w0.. for traverse1). Raw (t, prim), and
v3's counters, are held against the plain version. Each such row also prints
its CHAIN, from the plain version's counters: node steps per packet (max,
p99, median) and leaf rounds, and the packet walk's `node_pops` /
`tri_tests` beside the per-ray walk's (``traverse6_plain``) on the same rays:
what the union walk adds to the work, against what a step costs.

The packet walks over the wide tree (traverse5, traverse7; rows 3 and 4):
the camera wave, closest (row "a"), and the sorted incoherent rays, any-hit
(row "b"), v7 over the Woop table. Raw (t, prim) and the counters (node
steps and leaf clusters per packet) are held against the plain version
(``traverse5_plain`` / ``traverse7_plain``), and each row prints its chain
as the binary-tree rows do; the builds are timed without counters, as the
main path launches them.

For each row every build must be `equal` (and leave the overflow flag at 0);
the builds are timed in turns, forward then backward (A B C, C B A), by CUDA
events: median of 7 launches after 2 warm-ups in each turn (`ms_forward`,
`ms_backward`); then 20 launches queued back to back (`ms_queued`, device ms
a launch) beside the host's time to enqueue one (`host_ms`). Prints one JSON
line per row and build, ptxas' registers, shared memory and spills per
build, and at the end one `summary` line per kernel and build (queued ms of
each row, their sum over the real wave's launches, all rows equal or not).
A build whose launch the card refuses is reported and dropped. Needs one CUDA device and `nvcc`.
"""
import argparse
import ctypes
import dataclasses
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


# the binary-tree kernels: PERF.md's row, wrapper and plain version
ATTIC_ROWS = {"traverse1": ("5", tc.traverse, tc.traverse_plain),
              "traverse4": ("6", tc.traverse4, tc.traverse4_plain),
              "traverse3": ("7", tc.traverse3, tc.traverse3_plain),
              "traverse2": ("8", tc.traverse2, tc.traverse2_plain)}

# the packet walks over the wide tree: PERF.md's row
PACKET_ROWS = {"traverse5": "3", "traverse7": "4"}


def build_others(specs, kernels):
    """{name: "DIR[,flag...]"} -> ({kernel: {name: (library, ptxas
    report)}} for every kernel whose source DIR holds, ["name:kernel" that
    failed to build]). A build that fails is left out and fails the run."""
    out_dir = os.path.join(tc.BUILD_DIR, "compare")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for kern in kernels:
        for name, spec in specs.items():
            src_dir, *flags = spec.split(",")
            src = os.path.join(src_dir, kern + ".cu")
            if not os.path.exists(src):
                continue
            so = os.path.join(out_dir, f"lib{name}_{kern}.so")
            cmd = [tc._find_nvcc(), *tc.NVCC_FLAGS, *flags, "-o", so, src]
            procs[kern, name] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs, failed = {kern: {} for kern in kernels}, []
    for (kern, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed building {name} {kern}:\n{log}",
                  file=sys.stderr)
            failed.append(f"{name}:{kern}")
            continue
        lib = ctypes.CDLL(so)
        tc._bind(kern, lib)
        libs[kern][name] = (lib, log)
    return libs, failed


def resources(log):
    """ptxas' report -> [{registers, smem, stack, spill_stores}] per kernel
    (v6's motion instantiation is the one with ``ILb1E`` in its name)."""
    out = {}
    kern = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kern = ("motion" if "traverse6_kernel" in m.group(1)
                    and "ILb1E" in m.group(1) else "static")
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


def direct_wave_launches(scene, dev, kern):
    """The ray tensors of the 18 traversal launches of one direct-lighting
    wave (the third, at chip_smoke's width and depth) with every launch
    routed to the binary-tree kernel `kern`, as its wrapper got them:
    [(rays, keywords of the wrapper)] in launch order."""
    cam, smp, px, py, _ = cs.camera_wave(dev)
    film = film_mod.make_film(cs.WIDTH, cs.HEIGHT, device=dev)
    real, seen = tc._binary_cuda, []

    def keep(name, bvh, oc, dc, tmin, tmax, any_hit, counters):
        g = lambda x: x.clone()
        seen.append((vm.Rays(vm.V3(*map(g, oc)), vm.V3(*map(g, dc)),
                             g(tmin), g(tmax), None), {"any_hit": any_hit}))
        return real(name, bvh, oc, dc, tmin, tmax, any_hit, counters)

    with torch.no_grad(), cs.default_kernel("v" + kern[-1]):
        for s in range(3):
            if s == 2:
                tc._binary_cuda = keep
            try:
                film = rend.render_wave(
                    scene, cam, smp, film, px, py,
                    torch.full(px.shape, s, dtype=torch.int32, device=dev),
                    li_fn=cs.direct_li(), width=cs.WIDTH, height=cs.HEIGHT,
                    spp=smp.spp, device=dev)
            finally:
                tc._binary_cuda = real
    return seen


def chain(plain, per_ray, args, kw):
    """The plain version's counters and work on these rays beside the
    per-ray walk's: how long the heaviest packets' walks are."""
    stats, stats6 = {}, {}
    t, prim, cnt = plain(*args, **kw, counters=True, stats=stats)
    per_ray(*args, any_hit=kw.get("any_hit", False), stats=stats6)
    steps = cnt[:, 0].double().cpu().numpy()
    leaves = cnt[:, 1].double().cpu().numpy()
    return (t, prim, cnt), {
        "packets": int(cnt.shape[0]),
        "steps_max": int(steps.max()),
        "steps_p99": float(np.percentile(steps, 99)),
        "steps_median": float(np.median(steps)),
        "steps_mean": float(steps.mean()),
        "leaf_rounds_max": int(leaves.max()),
        "leaf_rounds_median": float(np.median(leaves)),
        "packet_node_pops": stats["node_pops"],
        "packet_tri_tests": stats["tri_tests"],
        "per_ray_node_pops": stats6["node_pops"],
        "per_ray_tri_tests": stats6["tri_tests"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", action="append",
                    choices=["traverse6", *ATTIC_ROWS, *PACKET_ROWS],
                    help="the kernel to compare (default traverse6; may be "
                    "repeated)")
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR[,nvcc flag...]")
    ap.add_argument("--real", action="store_true",
                    help="also the launches of one real wave: for traverse6 "
                    "a path wave, static (rows 1w0..) and moving (2w0..); for "
                    "a binary-tree kernel a direct-lighting wave (5w0.. for "
                    "traverse1)")
    ap.add_argument("--out", help="also write the JSON lines here")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs one CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    if a.out:       # written as the run goes: a run cut short keeps its rows
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        open(a.out, "w").close()

    def say(**kw):
        line = json.dumps(kw)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")

    say(card=cs.nvidia_smi_line(), torch=torch.__version__)
    kernels = a.kernel or ["traverse6"]
    others, failed = build_others(dict(s.split("=", 1) for s in a.other),
                                  kernels)
    tc.load_kernels(kernels)
    builds = {kern: {"packaged": tc._libs[kern],
                     **{k: v[0] for k, v in others[kern].items()}}
              for kern in kernels}
    say(resources={kern: {
        "packaged": resources(tc.BUILD_LOG.get(kern, "")),
        **{k: resources(v[1]) for k, v in others[kern].items()}}
        for kern in kernels})

    host = sb.bench_scene().build()
    scene = st.to_device(host, dev)
    _, _, _, _, cam_rays = cs.camera_wave(dev)
    rows = []    # (kernel, row, geometry, rays, keywords)
    if "traverse6" in kernels:
        mb = sb.bench_scene()
        mb.meshes[0].verts_end = mb.meshes[0].verts + np.asarray(
            cs.MOTION_SHIFT, np.float32)
        moving = st.to_device(mb.build(), dev)
        for tag, geom in (("1", scene.geometry), ("2", moving.geometry)):
            cam, inc, mixed, af = cs.wave_shapes(geom, dev, cam_rays)
            rows += [("traverse6", tag + "a", geom, cam, dict(any_hit=False)),
                     ("traverse6", tag + "b", geom, inc, dict(any_hit=True)),
                     ("traverse6", tag + "c", geom, mixed, dict(anyf=af))]
        if a.real:
            rows += [("traverse6", f"{tag}w{j}", sc.geometry, rays, kw)
                     for tag, sc in (("1", scene), ("2", moving))
                     for j, (rays, kw) in enumerate(
                         path_wave_launches(sc, dev))]
    attic = [kern for kern in kernels if kern in ATTIC_ROWS]
    if attic:
        geom = scene.geometry
        cam, inc, _, _ = cs.wave_shapes(geom, dev, cam_rays)
        for kern in attic:
            tag = ATTIC_ROWS[kern][0]
            rows += [(kern, tag + "a", geom, cam, dict(any_hit=False)),
                     (kern, tag + "b", geom, inc, dict(any_hit=True))]
            if a.real:
                rows += [(kern, f"{tag}w{j}", geom, rays, kw)
                         for j, (rays, kw) in enumerate(
                             direct_wave_launches(scene, dev, kern))]
    packet = [kern for kern in kernels if kern in PACKET_ROWS]
    if packet:
        geom = dataclasses.replace(scene.geometry, packed=tc.with_woop(
            host.geometry.packed).to(dev))
        cam, inc, _, _ = cs.wave_shapes(geom, dev, cam_rays)
        for kern in packet:
            tag = PACKET_ROWS[kern]
            rows += [(kern, tag + "a", geom, cam, dict(any_hit=False)),
                     (kern, tag + "b", geom, inc, dict(any_hit=True))]
    bad = []
    summary = {}    # (kernel, build) -> {row: queued ms}
    for kern, row, geom, rays, kw in rows:
        args = (geom.packed, rays.o, rays.d, rays.tmin, rays.tmax)
        extra = {}
        check = None    # the call held against `want`, where not `run`
        if kern == "traverse6":
            if geom.has_motion:
                kw["time"] = rays.time
            want = tc.traverse6_plain(*args, **kw)
            run = lambda: tc.traverse6(*args, **kw)
        elif kern in PACKET_ROWS:
            fn = getattr(tc, kern)
            want, extra = chain(getattr(tc, kern + "_plain"),
                                tc.traverse6_plain, args, kw)
            run = lambda: fn(*args, **kw)
            check = lambda: fn(*args, **kw, counters=True)
        else:
            _, fn, plain = ATTIC_ROWS[kern]
            want, extra = chain(plain, tc.traverse6_plain, args, kw)
            if kern == "traverse3":
                kw = dict(kw, counters=True)
            else:
                want = want[:2]
            run = lambda: fn(*args, **kw)
        lib_of = builds[kern]
        equal = {}
        for name, lib in list(lib_of.items()):
            tc._libs[kern] = lib
            tc.reset_overflow(dev)
            try:
                got = (check or run)()
            except RuntimeError as e:   # a launch the card refused
                print(f"{name} {kern} {row}: {e}", file=sys.stderr)
                bad.append((row, name))
                del builds[kern][name]
                continue
            torch.cuda.synchronize()
            equal[name] = (all(torch.equal(g, w) for g, w in zip(got, want))
                           and int(tc.overflow_flag(dev).item()) == 0)
            if not equal[name]:
                bad.append((row, name))
        ms, queued = {name: [] for name in lib_of}, {}
        for order in (list(lib_of), list(lib_of)[::-1]):
            for name in order:
                tc._libs[kern] = lib_of[name]
                ms[name].append(cs.time_ms(run, repeats=7, warmup=2))
        for name in lib_of:
            tc._libs[kern] = lib_of[name]
            queued[name] = queued_and_host_ms(run)
        tc._libs[kern] = lib_of["packaged"]
        first = next((k for k in lib_of if k != "packaged"), None)
        for name in lib_of:
            say(kernel=kern, row=row, lanes=rays.n, build=name,
                equal=equal[name], ms_forward=ms[name][0],
                ms_backward=ms[name][1], ms_queued=queued[name][0],
                host_ms=queued[name][1],
                vs_first_other=(None if first is None else min(ms[name]) / min(
                    ms[first])),
                queued_vs_first_other=(None if first is None else
                                       queued[name][0] / queued[first][0]))
            summary.setdefault((kern, name), {})[row] = queued[name][0]
        if extra:
            say(kernel=kern, row=row, chain=extra)
    # one line per kernel and build: queued ms of each row, the sum over a
    # real wave's launches, and whether every row was equal
    for (kern, name), got in summary.items():
        wave = [v for r, v in got.items() if "w" in r]
        mine = {row for k, row, *_ in rows if k == kern}
        say(summary=kern, build=name,
            equal=not any(b == name and r in mine for r, b in bad),
            queued_ms={r: v for r, v in got.items() if "w" not in r},
            real_launches=len(wave), real_queued_ms_sum=sum(wave))
    if bad:
        print(f"differs from the plain version: {bad}", file=sys.stderr)
    if failed:
        print(f"did not build: {failed}", file=sys.stderr)
    return 1 if bad or failed else 0


if __name__ == "__main__":
    sys.exit(main())
