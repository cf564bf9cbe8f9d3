"""Make the golden that the whole-render tests of
``tests/test_torch_render.py`` and the moving-sphere traversal test of
``tests/test_torch_motion.py`` hold the PyTorch port against.

    JAX_PLATFORMS=cpu python tools/make_render_golden.py [--out FILE]

It runs the JAX reference on the CPU, its Pallas traversal kernel in
interpret mode, and writes ``tools/render_golden.npz``:

  cornell_img, cornell_pixels  the Cornell box (``scene.build.cornell_box``)
                  through ``render_wave`` un-jitted: 16x16, lowdiscrepancy
                  2 spp, path depth 2: the image and the film accumulator
  moving_img      the same box with its matte sphere translating by SHIFT
                  over the shutter, 1 spp, depth 3 (the kernel's motion mode)
  bench_img       the benchmark scene family at BENCH_TRIS triangles, the
                  benchmark's camera, 1 spp, depth 4
  motion_*        the moving sphere of ``tests/test_bvh.py`` and the ray set
                  of ``motion_rays``: (t, prim) of ``intersect`` by the CPU
                  walk (cpu_), by the kernel (kernel_) and of the mixed
                  launch (pair_), the any-hit masks of the CPU walk and the
                  kernel, and the CPU walk's hit points (motion_p)

The renders take about a minute. The tests read the file; one ``slow`` case
in each calls ``make`` again and compares.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "render_golden.npz")

W = H = 16
SPP = 2
DEPTH = 2
EYE, LOOK, UP, FOV = [0, 1, -3.2], [0, 1, 0], [0, 1, 0], 40.0
SPHERE = 6          # the matte sphere among the meshes of cornell_box()
SHIFT = np.asarray([0.5, 0, 0], np.float32)
BENCH_TRIS = 2000
BENCH_VIEW = ([0, 2.2, -5.0], [0, 0.9, 0], 42.0, 4)   # eye, look, fov, depth
MOTION_SHIFT = np.asarray([2.0, 0, 0], np.float32)
MOTION_N = 256


def moving_cornell(mod, shift):
    """The Cornell box with its matte sphere translating by `shift` over the
    cameras' default shutter [0, 1] (`mod`: either package's scene.build)."""
    b = mod.cornell_box()
    b.meshes[SPHERE].verts_end = b.meshes[SPHERE].verts + shift
    return b.build()


def moving_sphere(mod):
    """The moving sphere (`mod`: either package's scene.mesh)."""
    m = mod.sphere(radius=0.5, nu=24, nv=12)
    m.verts_end = m.verts + MOTION_SHIFT
    return m


def motion_rays():
    """(o, d, ts): rays aimed at the lerped sphere from a ring of origins,
    with random times."""
    rng = np.random.RandomState(11)
    ts = rng.rand(MOTION_N).astype(np.float32)
    ang = rng.rand(MOTION_N) * 2 * np.pi
    o = np.stack([2.0 * ts + 3.0 * np.cos(ang), 3.0 * np.sin(ang),
                  -3.0 * np.ones(MOTION_N)], -1).astype(np.float32)
    c = np.stack([2.0 * ts, np.zeros(MOTION_N), np.zeros(MOTION_N)], -1)
    d = (c - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, ts


def _jax():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    return jax


def reference_render(host, eye, look, fov, spp, depth, li=None):
    """The reference's film after `spp` waves of ``render_wave`` (the path
    integrator unless `li` is given), un-jitted."""
    _jax()
    import jax.numpy as jnp
    from dartray_tpu import cameras as ref_cam
    from dartray_tpu import film as ref_film
    from dartray_tpu import samplers as ref_samplers
    from dartray_tpu.core import transform as ref_tr
    from dartray_tpu.integrators import path as ref_pi
    from dartray_tpu.renderers import sampler as ref_rend
    from dartray_tpu.scene import types as ref_st
    scene = ref_st.to_device(host)
    cam = ref_cam.perspective(ref_tr.look_at(eye, look, UP), fov, W, H)
    smp = ref_samplers.make_sampler("lowdiscrepancy", spp=spp)
    if li is None:
        ig = ref_pi.PathIntegrator(max_depth=depth, remat=False)
        li = lambda s, r, d, c: ref_pi.li(ig, s, r, d, c)  # noqa: E731
    film = ref_film.make_film(W, H)
    px, py = ref_rend.pixel_grid(W, H)
    for s in range(smp.spp):
        film = ref_rend.render_wave(
            scene, cam, smp, film, px, py, jnp.full(px.shape, s, jnp.int32),
            li_fn=li, width=W, height=H, spp=smp.spp)
    return film


def reference_bench_scene(n_tris):
    """The benchmark scene family, built by the reference's own modules as
    its benchmark script builds it (displaced matte sphere, glass sphere,
    matte floor, diffuse area light)."""
    _jax()
    from dartray_tpu import materials as ref_mat
    from dartray_tpu.core import transform as ref_tr
    from dartray_tpu.scene import build as ref_sb
    from dartray_tpu.scene import mesh as ref_mesh
    b = ref_sb.SceneBuilder()
    gray = b.add_material(ref_mat.matte(kd=(0.6, 0.6, 0.6)))
    floor_m = b.add_material(ref_mat.matte(kd=(0.4, 0.4, 0.45)))
    glass_m = b.add_material(ref_mat.glass())
    dark = b.add_material(ref_mat.matte(kd=(0.0, 0.0, 0.0)))
    nu = int(np.sqrt(n_tris / 2 * (2.0)))
    nv = max(nu // 2, 8)
    m = ref_mesh.sphere(radius=1.0, nu=nu, nv=nv)
    v = m.verts.astype(np.float64)
    disp = (0.08 * np.sin(7 * v[:, 0]) * np.cos(5 * v[:, 1])
            + 0.05 * np.sin(11 * v[:, 2] + 3 * v[:, 0]))
    n = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    m.verts = (v + n * disp[:, None]).astype(np.float32)
    m.normals = None
    b.add_mesh(m.transformed(np.asarray(
        ref_tr.translate([-0.4, 1.05, 0.2]).m)), gray)
    b.add_mesh(ref_mesh.sphere(radius=0.5, nu=64, nv=32).transformed(
        np.asarray(ref_tr.translate([1.2, 0.5, -0.6]).m)), glass_m)
    b.add_mesh(ref_mesh.make_mesh(
        [[-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6]],
        [[0, 1, 2], [0, 2, 3]]), floor_m)
    b.add_mesh(ref_mesh.make_mesh(
        [[-1, 4, -1], [1, 4, -1], [1, 4, 1], [-1, 4, 1]],
        [[0, 1, 2], [0, 2, 3]]), dark, area_light_L=(12.0,) * 3)
    return b.build()


def reference_motion():
    """The reference's traversal of ``motion_rays`` over the moving sphere,
    as {motion_*: array}."""
    _jax()
    import jax.numpy as jnp
    from dartray_tpu.core import math as ref_vm
    from dartray_tpu.scene import mesh as ref_mesh
    from dartray_tpu.scene import types as ref_st
    geom = ref_st.to_device(ref_st.compile_geometry(
        [moving_sphere(ref_mesh)], [0], [-1]))
    o, d, ts = motion_rays()
    rays = ref_vm.make_rays(
        ref_vm.V3(*(jnp.asarray(o[:, c]) for c in range(3))),
        ref_vm.V3(*(jnp.asarray(d[:, c]) for c in range(3))),
        time=jnp.asarray(ts))
    out = {}
    saved = ref_st.FORCE_PALLAS_INTERPRET
    try:
        ref_st.FORCE_PALLAS_INTERPRET = False
        h = ref_st.intersect(geom, rays)
        out["motion_cpu_occ"] = np.asarray(ref_st.intersect_p(geom, rays))
        it = ref_st.interaction(geom, rays, h)
        out["motion_p"] = np.stack([np.asarray(c) for c in it["p"]], -1)
        ref_st.FORCE_PALLAS_INTERPRET = True
        hk = ref_st.intersect(geom, rays)
        hp, occ_k = ref_st.intersect_pair(geom, rays, rays)
        out["motion_kernel_occ"] = np.asarray(occ_k)
    finally:
        ref_st.FORCE_PALLAS_INTERPRET = saved
    for name, hh in (("cpu", h), ("kernel", hk), ("pair", hp)):
        out[f"motion_{name}_t"] = np.asarray(hh.t)
        out[f"motion_{name}_prim"] = np.asarray(hh.prim)
    return out


def make():
    """({name: array}, seconds per part) from the reference."""
    _jax()
    from dartray_tpu import film as ref_film
    from dartray_tpu.scene import build as ref_sb
    from dartray_tpu.scene import types as ref_st
    out, seconds = {}, {}
    saved = ref_st.FORCE_PALLAS_INTERPRET
    ref_st.FORCE_PALLAS_INTERPRET = True
    try:
        t0 = time.time()
        film = reference_render(ref_sb.cornell_box().build(), EYE, LOOK, FOV,
                                SPP, DEPTH)
        out["cornell_img"] = np.asarray(ref_film.to_rgb(film))
        out["cornell_pixels"] = np.asarray(film.pixels)
        seconds["cornell"] = time.time() - t0
        t0 = time.time()
        film = reference_render(moving_cornell(ref_sb, SHIFT), EYE, LOOK,
                                FOV, 1, 3)
        out["moving_img"] = np.asarray(ref_film.to_rgb(film))
        seconds["moving"] = time.time() - t0
        t0 = time.time()
        eye, look, fov, depth = BENCH_VIEW
        film = reference_render(reference_bench_scene(BENCH_TRIS), eye, look,
                                fov, 1, depth)
        out["bench_img"] = np.asarray(ref_film.to_rgb(film))
        seconds["bench"] = time.time() - t0
    finally:
        ref_st.FORCE_PALLAS_INTERPRET = saved
    t0 = time.time()
    out.update(reference_motion())
    seconds["motion"] = time.time() - t0
    return out, seconds


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=GOLDEN)
    out = ap.parse_args().out
    arrays, seconds = make()
    np.savez_compressed(out, **arrays)
    print("wrote", out, {k: round(v, 1) for k, v in seconds.items()})


if __name__ == "__main__":
    main()
