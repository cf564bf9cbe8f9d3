"""Make the goldens that ``tests/test_torch_prt.py``,
``tests/test_torch_metropolis.py`` and ``chip_smoke.py`` hold the PyTorch
port's precomputed-transfer integrators, probes, bidirectional radiance and
Metropolis renderer against.

    JAX_PLATFORMS=cpu python tools/make_prt_golden.py [--out FILE]

It renders scenes/prt.pbrt (16 x 16, lowdiscrepancy 2 spp: an open box with
a ceiling area light, an infinite light over envmap.pfm, a matte, a plastic
and a glass sphere) with the JAX reference's own
``dartray_tpu.renderers.manager.render_pbrt`` on the CPU, in the variants of
its SurfaceIntegrator and Renderer lines (``variant_text``), into
``tools/prt_golden.npz``:

  diffuseprt     as written: lmax 4, nsamples 64
  glossyprt      lmax 4, nsamples 64
  createprobes   indirectsamples 64 through path at maxdepth 2; its probe
                 file gives probes_{coeffs,bbox_lo,bbox_hi} (64 probes)
  useprobes      over that file
  mlt            metropolis: samplesperpixel 64 (2 steps of 8,192 chains),
                 bootstrapsamples 1024, maxdepth 3, dodirectseparately true
  mlt_nodirect   the same with dodirectseparately false

and, from the same scene: ``c_in``, the incident radiance at the world
bound's centre at the defaults (lmax 4, 4,096 directions, seed 7), and
``path_l``, the radiance ``_radiance_for`` gives with
``bdpt.path_l(max_depth=4)`` on the primary samples ``path_l_u()``
(4,096 x 116 float32 from numpy's RandomState(PATH_L_SEED)).

The reference runs un-jitted: its render loop, the probe bake and the MLT
radiance and step as Python calls, its ``fori_loop``s with Python bounds
and ``lax.scan`` as Python loops, its traversal through its own CPU walk
over the cluster BVH, each walk jitted once. The createprobes / useprobes
pair runs in a temporary working directory (the reference writes and reads
``probes.npz`` there). ``main`` prints the seconds each part took; the
tests read the file and their slow cases call ``make`` again and compare.
"""
import argparse
import contextlib
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "prt_golden.npz")
SCENES = os.path.join(ROOT, "scenes")
SCENE = os.path.join(SCENES, "prt.pbrt")
INTEGRATOR_LINE = 'SurfaceIntegrator "diffuseprt" "integer nsamples" [64]'
RENDERER_LINE = 'Renderer "sampler"'
MLT_LINE = ('Renderer "metropolis" "integer samplesperpixel" [64] '
            '"integer bootstrapsamples" [1024] "integer maxdepth" [3] '
            '"bool dodirectseparately" ["{}"]')
LINES = {
    "diffuseprt": {},
    "glossyprt": {INTEGRATOR_LINE: INTEGRATOR_LINE.replace("diffuseprt",
                                                           "glossyprt")},
    "createprobes": {
        INTEGRATOR_LINE: 'SurfaceIntegrator "path" "integer maxdepth" [2]',
        RENDERER_LINE: 'Renderer "createprobes" "integer indirectsamples" '
                       '[64]'},
    "useprobes": {INTEGRATOR_LINE: 'SurfaceIntegrator "useprobes"'},
    "mlt": {RENDERER_LINE: MLT_LINE.format("true")},
    "mlt_nodirect": {RENDERER_LINE: MLT_LINE.format("false")},
}
VARIANTS = tuple(LINES)
PATH_L_SEED = 3
PATH_L_LANES = 4096
PATH_L_DEPTH = 4


def variant_text(name):
    """The scene text of a variant: prt.pbrt with its lines swapped."""
    with open(SCENE) as f:
        text = f.read()
    for old, new in LINES[name].items():
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def path_l_u(n=PATH_L_LANES, depth=PATH_L_DEPTH):
    """The fixed primary samples of the path_l golden: (n, dims) float32."""
    dims = 5 + 4 * depth + 7 * depth + 6 + 4 * depth
    return np.random.RandomState(PATH_L_SEED).rand(n, dims).astype(
        np.float32)


@contextlib.contextmanager
def reference():
    """The JAX reference as the goldens are made: un-jitted render loop,
    probe bake and Metropolis radiance and step, Python-bound ``fori_loop``s
    and ``lax.scan`` as Python loops (a loop body sees an int32 index, as
    traced), the CPU cluster walks jitted once."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, ROOT)
    from dartray_tpu.accel import cluster
    from dartray_tpu.renderers import metropolis, probes
    from dartray_tpu.renderers import sampler as ref_sampler
    from dartray_tpu.scene import types as ref_st

    real_fori, real_scan = jax.lax.fori_loop, jax.lax.scan

    def fori_loop(lower, upper, body, init):
        if not (isinstance(lower, int) and isinstance(upper, int)):
            return real_fori(lower, upper, body, init)
        val = init
        for i in range(lower, upper):
            val = body(jnp.int32(i), val)
        return val

    def scan(f, init, xs):
        carry = init
        for i in range(xs.shape[0]):
            carry, _ = f(carry, xs[i])
        return carry, None

    class Unjitted:
        """jax as the reference's render loops see it, jit left out."""

        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def jit(fn, **_):
            return fn

    mods = (ref_sampler, probes, metropolis)
    saved = (ref_st.FORCE_PALLAS_INTERPRET, cluster.intersect,
             cluster.intersect_p) + tuple(m.jax for m in mods)
    ref_st.FORCE_PALLAS_INTERPRET = False
    cluster.intersect = jax.jit(saved[1])
    cluster.intersect_p = jax.jit(saved[2])
    for m in mods:
        m.jax = Unjitted()
    jax.lax.fori_loop, jax.lax.scan = fori_loop, scan
    try:
        yield
    finally:
        jax.lax.fori_loop, jax.lax.scan = real_fori, real_scan
        (ref_st.FORCE_PALLAS_INTERPRET, cluster.intersect,
         cluster.intersect_p) = saved[:3]
        for m, j in zip(mods, saved[3:]):
            m.jax = j


def _parse(text):
    from dartray_tpu.scene import parser, resources
    return parser.parse(text, resolver=resources.Resolver([SCENES]),
                        log=lambda *a, **k: None)


def reference_c_in():
    """The reference's incident radiance at the world bound's centre."""
    from dartray_tpu.integrators import prt
    job = _parse(variant_text("diffuseprt"))
    wb = np.asarray(job.scene.geometry.world_bound)
    return np.asarray(prt.project_incident_radiance(
        job.scene, 0.5 * (wb[0] + wb[1]), 4, 4096))


def reference_path_l():
    """The reference's ``_radiance_for`` with ``bdpt.path_l`` on
    ``path_l_u()`` (L * camera weight, non-finite zeroed)."""
    from functools import partial
    import jax.numpy as jnp
    from dartray_tpu.core import math as vm
    from dartray_tpu.integrators import bdpt
    from dartray_tpu.renderers import metropolis
    from dartray_tpu.scene import types as ref_st
    job = _parse(variant_text("mlt"))
    scene = ref_st.to_device(job.scene)
    li = partial(bdpt.path_l, max_depth=PATH_L_DEPTH, bidirectional=True,
                 skip_direct=False)
    L, _ = metropolis._radiance_for(scene, job.camera, job.width, job.height,
                                    li, jnp.asarray(path_l_u()),
                                    PATH_L_DEPTH)
    return np.asarray(vm.to_arr(L))


def make(names=VARIANTS):
    """({name: float32 image} plus c_in, probes_* and path_l, seconds per
    part), from the reference."""
    out, seconds = {}, {}
    with reference(), tempfile.TemporaryDirectory() as tmp:
        from dartray_tpu.renderers import manager
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            for name in names:
                t0 = time.time()
                img = manager.render_pbrt(variant_text(name),
                                          search_paths=[SCENES],
                                          log=lambda *a, **k: None)
                seconds[name] = time.time() - t0
                if name == "createprobes":
                    z = np.load("probes.npz")
                    out.update({f"probes_{k}": z[k] for k in
                                ("coeffs", "bbox_lo", "bbox_hi")})
                else:
                    out[name] = np.asarray(img, np.float32)
        finally:
            os.chdir(cwd)
        t0 = time.time()
        out["c_in"] = reference_c_in()
        seconds["c_in"] = time.time() - t0
        t0 = time.time()
        out["path_l"] = reference_path_l()
        seconds["path_l"] = time.time() - t0
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
