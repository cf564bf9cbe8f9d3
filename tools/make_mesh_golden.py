"""Make the golden that ``tests/test_torch_mesh.py`` and ``chip_smoke.py``
(``mesh_path`` (a)) hold the PyTorch port's band-sharded renderer against.

    python tools/make_mesh_golden.py [--out FILE]

It runs the JAX reference's ``parallel/mesh.py::render_sharded`` on an
8-device virtual CPU mesh (``--xla_force_host_platform_device_count=8``, as
the reference's own tests run it) and writes ``tools/mesh_golden.npz``:

  dryrun_img    ``__graft_entry__.py::dryrun_multichip(8)``'s configuration:
                the Cornell box (``scene.build.cornell_box``), 16x16, a
                4 x 2 (tiles x spp) mesh, lowdiscrepancy 4 spp, path depth
                5, box filter
  gaussian_img  ``tests/test_sharding.py::test_sharded_gaussian_margin_
                compose``'s: its matte sphere over a floor under an infinite
                light, 16x16, 4 x 2, 2 spp, depth 2, gaussian filter (a
                margin of 2 rows a band)

Each render compiles the whole sharded render for a few minutes on the CPU
and then runs in seconds. The tests read the file; one ``slow`` case an
image calls ``make`` again and compares.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "mesh_golden.npz")

W = H = 16
MESH = (4, 2)                      # (n_tiles, n_spp) of both images
# name -> (scene, eye, look, fov, spp, depth, filter)
CONFIGS = {
    "dryrun": ("cornell", [0, 1.0, -3.6], [0, 1.0, 0], 40.0, 4, 5, "box"),
    "gaussian": ("sphere_floor", [0, 0.5, -4], [0, 0, 0], 35.0, 2, 2,
                 "gaussian"),
}
UP = [0, 1, 0]


def sphere_floor(sb, mesh, mat, lights):
    """``tests/test_sharding.py::_scene``, from either package's modules:
    a matte sphere over a matte floor under an infinite light."""
    b = sb.SceneBuilder()
    m = b.add_material(mat.matte(kd=(0.5,) * 3))
    b.add_mesh(mesh.sphere(radius=1.0, nu=16, nv=8), m)
    b.add_mesh(mesh.make_mesh([[-5, -1.2, -5], [5, -1.2, -5], [5, -1.2, 5],
                               [-5, -1.2, 5]], [[0, 1, 2], [0, 2, 3]]), m)
    b.add_light(lights.infinite_light(
        np.ones((4, 8, 3), np.float32) * [[[1.0, 0.8, 0.6]]]))
    return b.build()


def port_setup(name, device="cuda"):
    """(host scene, camera, sampler, li_fn, filter) of CONFIGS[name] for the
    PyTorch port, the camera on `device`."""
    sys.path.insert(0, ROOT)
    from dartray_tpu_torch import cameras, samplers
    from dartray_tpu_torch import lights as lt_mod
    from dartray_tpu_torch import materials as mat_mod
    from dartray_tpu_torch.core import transform as tr
    from dartray_tpu_torch.integrators import path as pi
    from dartray_tpu_torch.scene import build as sb, mesh
    kind, eye, look, fov, spp, depth, filt = CONFIGS[name]
    scene = (sb.cornell_box().build() if kind == "cornell"
             else sphere_floor(sb, mesh, mat_mod, lt_mod))
    cam = cameras.perspective(tr.look_at(eye, look, UP), fov, W, H,
                              device=device)
    smp = samplers.make_sampler("lowdiscrepancy", spp=spp)
    ig = pi.PathIntegrator(max_depth=depth)
    return (scene, cam, smp, lambda s, r, d, c: pi.li(ig, s, r, d, c),
            filt)


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    return jax


def reference_image(name):
    """The reference's ``render_sharded`` image of CONFIGS[name]."""
    jax = _jax()
    assert len(jax.devices()) >= MESH[0] * MESH[1], jax.devices()
    from dartray_tpu import cameras, samplers
    from dartray_tpu import lights as ref_lights
    from dartray_tpu import materials as ref_mat
    from dartray_tpu.core import transform as tr
    from dartray_tpu.integrators import path as pi
    from dartray_tpu.parallel import mesh as pmesh
    from dartray_tpu.scene import build as ref_sb
    from dartray_tpu.scene import mesh as ref_mesh
    kind, eye, look, fov, spp, depth, filt = CONFIGS[name]
    scene = (ref_sb.cornell_box().build() if kind == "cornell"
             else sphere_floor(ref_sb, ref_mesh, ref_mat, ref_lights))
    cam = cameras.perspective(tr.look_at(eye, look, UP), fov, W, H)
    smp = samplers.make_sampler("lowdiscrepancy", spp=spp)
    ig = pi.PathIntegrator(max_depth=depth)
    li = lambda s, r, d, c: pi.li(ig, s, r, d, c)  # noqa: E731
    m = pmesh.make_device_mesh(*MESH)
    return np.asarray(pmesh.render_sharded(scene, cam, smp, li, W, H, m,
                                           filter_name=filt))


def make(names=tuple(CONFIGS)):
    """({name_img: array}, seconds per image) from the reference."""
    out, seconds = {}, {}
    for name in names:
        t0 = time.time()
        out[f"{name}_img"] = reference_image(name)
        seconds[name] = time.time() - t0
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
