"""RenderManager: RenderJob -> image, the user-facing render orchestration
(counterpart of the JAX reference's ``renderers/manager.py``).

``render_pbrt`` parses a scene file or text, applies the render overrides and
runs the job on `device` (default the card; asking for a card that is not
there raises). ``run`` dispatches on the job's renderer: ``sampler`` (the
wavefront render of ``renderers/sampler.py``, or its ``render_adaptive``
when the scene asks for the adaptive sampler) or ``aggregatetest`` (random
rays through the BVH against the exhaustive intersector). The surface
integrators are ``path``, ``directlighting``, ``whitted``,
``ambientocclusion`` and ``igi`` (its VPLs shot when the job's radiance
function is built); an unknown name warns and renders with ``path``, as in
the reference. The cache-and-gather integrators run their preprocess when
the job's radiance function is built, on the job's device: ``photonmap`` /
``exphotonmap`` shoot their photon maps, ``irradiancecache`` primes its
cache and ``dipolesubsurface`` spreads surface points and their irradiance.
The precomputed-transfer integrators ``diffuseprt`` / ``glossyprt``
project the incident radiance at the world bound's centre, and
``useprobes`` loads its probe file (relative to the working directory,
``lmax`` from the file). The ``surfacepoints`` and ``createprobes``
renderers write their points or probes to a file and return a black image;
``metropolis`` runs the MLT renderer (always bidirectional, 8,192 chains,
seed 0). A scene with a volume composes the surface radiance with the
volume integrator's over the camera segment (``build_li``: L = T Ls + Lv,
``emission`` by default or ``single``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import cameras as cam_mod
from .. import device as device_mod
from .. import log as log_mod
from .. import samplers as smp_mod
from .. import stats as stats_mod
from ..accel import traverse as tv
from ..core import math as vm
from ..core import spectrum as spec_mod
from ..integrators import ao as ao_mod
from ..integrators import dipole as dp_mod
from ..integrators import direct as di_mod
from ..integrators import igi as igi_mod
from ..integrators import irradiance_cache as ic_mod
from ..integrators import path as pi_mod
from ..integrators import photonmap as pm_mod
from ..integrators import prt as prt_mod
from ..integrators import volume as vi_mod
from ..integrators import whitted as wh_mod
from ..scene import paramset as ps_mod
from ..scene import parser as parser_mod
from ..scene import resources
from ..scene import types as st
from ..scene.api import RenderJob
from . import metropolis as mlt_mod
from . import probes as probes_mod
from . import sampler as rend
from . import surface_points as sp_mod


def build_surface_li(job: RenderJob, log=print,
                     device=device_mod.DEFAULT) -> Callable:
    """The surface integrator of `job` as ``li(scene, rays, diffs, sctx)``;
    unknown names warn and fall back to path. An integrator with a
    preprocess phase (igi's VPLs, the photon maps, the irradiance cache,
    the dipole's surface points, the PRT integrators' incident radiance)
    runs it here, on `device`."""
    name = job.surf_integrator
    p = job.surf_params
    if name == "ambientocclusion":
        ig = ao_mod.AOIntegrator(
            n_samples=p.find_one_int("nsamples", 2048),
            min_dist=p.find_one_float("mindist", 1e-4),
            max_dist=p.find_one_float("maxdist", float("inf")))
        return lambda s, r, d, c: ao_mod.li(ig, s, r, d, c)
    if name == "directlighting":
        strat = p.find_one_string("strategy", "all")
        ig = di_mod.DirectLightingIntegrator(
            strategy=di_mod.STRATEGY_ONE if strat == "one"
            else di_mod.STRATEGY_ALL,
            max_depth=p.find_one_int("maxdepth", 5))
        return lambda s, r, d, c: di_mod.li(ig, s, r, d, c)
    if name == "whitted":
        ig = wh_mod.WhittedIntegrator(max_depth=p.find_one_int("maxdepth", 5))
        return lambda s, r, d, c: wh_mod.li(ig, s, r, d, c)
    if name == "igi":
        ig = igi_integrator(p)
        vpls = igi_mod.preprocess(ig, job.scene, device=device)
        return lambda s, r, d, c: igi_mod.li(ig, s, r, d, c, vpls)
    if name in ("photonmap", "exphotonmap"):
        ig = photonmap_integrator(p)
        maps = pm_mod.shoot_photons(ig, job.scene, device=device)
        return lambda s, r, d, c: pm_mod.li(ig, s, r, d, c, maps)
    if name == "irradiancecache":
        ig = irradiance_cache_integrator(p)
        cache = ic_mod.build_cache(ig, job.scene, job.camera, job.width,
                                   job.height, device=device)
        return lambda s, r, d, c: ic_mod.li(ig, s, r, d, c, cache)
    if name == "dipolesubsurface":
        ig = dipole_integrator(p)
        sp = sp_mod.render(job.scene, min_sample_dist=ig.min_sample_dist,
                           device=device)
        ip = dp_mod.prepare(job.scene, sp, device=device)
        sps, sa, sss_mask = dipole_medium(job, log=log, device=device)
        return lambda s, r, d, c: dp_mod.li(ig, s, r, d, c, ip,
                                            sigma_prime_s=sps, sigma_a=sa,
                                            sss_mask=sss_mask)
    if name in ("diffuseprt", "glossyprt"):
        ig = prt_integrator(name, p)
        c_in = prt_mod.project_incident_radiance(
            job.scene, scene_center(job.scene), ig.lmax, ig.n_samples,
            device=device)
        li = prt_mod.diffuse_li if name == "diffuseprt" else prt_mod.glossy_li
        return lambda s, r, d, c: li(ig, s, r, d, c, c_in)
    if name == "useprobes":
        probes = probes_mod.load(p.find_one_string("filename", "probes.npz"),
                                 device=device)
        # T = (lmax + 1)^2 coefficients a probe: lmax comes from the file
        ig = prt_mod.UseProbesIntegrator(
            lmax=int(np.sqrt(probes.coeffs.shape[1])) - 1)
        return lambda s, r, d, c: prt_mod.probes_li(ig, s, r, d, c, probes)
    if name != "path":
        log(f"warning: unknown surface integrator {name!r}; using path")
    ig = pi_mod.PathIntegrator(max_depth=p.find_one_int("maxdepth", 5))
    return lambda s, r, d, c: pi_mod.li(ig, s, r, d, c)


def prt_integrator(name, p):
    """The ``diffuseprt`` or ``glossyprt`` integrator a ParamSet asks
    for."""
    cls = (prt_mod.DiffusePRTIntegrator if name == "diffuseprt"
           else prt_mod.GlossyPRTIntegrator)
    return cls(lmax=p.find_one_int("lmax", 4),
               n_samples=p.find_one_int("nsamples", 4096))


def scene_center(scene):
    """The centre of the scene's world bound (host float32 (3,))."""
    wb = scene.geometry.world_bound
    wb = wb.cpu().numpy() if torch.is_tensor(wb) else np.asarray(wb)
    return 0.5 * (wb[0] + wb[1])


def metropolis_options(rp) -> dict:
    """The keyword arguments of ``metropolis.render`` a ``Renderer
    "metropolis"`` ParamSet gives: no chain count, seed or
    ``bidirectional`` (the defaults: 8,192 chains, seed 0,
    bidirectional)."""
    return dict(
        spp=rp.find_one_int("samplesperpixel", 100),
        n_bootstrap=rp.find_one_int("bootstrapsamples", 4096),
        large_step_prob=rp.find_one_float("largestepprobability", 0.25),
        max_depth=rp.find_one_int("maxdepth", 7),
        max_consecutive_rejects=rp.find_one_int("maxconsecutiverejects",
                                                512),
        do_direct_separately=rp.find_one_bool("dodirectseparately", True))


def createprobes_options(rp) -> tuple:
    """What a ``Renderer "createprobes"`` ParamSet gives: the keyword
    arguments of ``probes.render`` (lmax, n_samples; the 4 x 4 x 4 grid
    over the world bound, seed 11, chunks of 4 always) and the file
    name."""
    return dict(lmax=rp.find_one_int("lmax", 4),
                n_samples=rp.find_one_int("indirectsamples", 512)), \
        rp.find_one_string("filename", "probes.npz")


def igi_integrator(p) -> igi_mod.IGIIntegrator:
    """The IGI integrator a ``SurfaceIntegrator "igi"`` ParamSet asks
    for."""
    return igi_mod.IGIIntegrator(
        n_light_paths=p.find_one_int("nlights", 64),
        n_light_sets=p.find_one_int("nsets", 4),
        max_depth=p.find_one_int("maxdepth", 5),
        g_limit=p.find_one_float("glimit", 10.0))


def photonmap_integrator(p) -> pm_mod.PhotonMapIntegrator:
    """The photon map integrator a ``SurfaceIntegrator "photonmap"`` (or
    ``"exphotonmap"``) ParamSet asks for; ``nused`` is read and never used,
    the depths are not read."""
    return pm_mod.PhotonMapIntegrator(
        n_caustic=p.find_one_int("causticphotons", 20_000),
        n_indirect=p.find_one_int("indirectphotons", 100_000),
        n_lookup=p.find_one_int("nused", 50),
        max_dist=p.find_one_float("maxdist", 0.1),
        final_gather=p.find_one_bool("finalgather", True),
        gather_samples=p.find_one_int("finalgathersamples", 32))


def irradiance_cache_integrator(p) -> ic_mod.IrradianceCacheIntegrator:
    """The irradiance cache integrator a ``SurfaceIntegrator
    "irradiancecache"`` ParamSet asks for."""
    return ic_mod.IrradianceCacheIntegrator(
        min_weight=p.find_one_float("minweight", 0.5),
        max_angle_deg=p.find_one_float("maxanglediff", 10.0),
        n_samples=p.find_one_int("nsamples", 4096),
        max_depth=p.find_one_int("maxdepth", 5))


def dipole_integrator(p) -> dp_mod.DipoleSubsurfaceIntegrator:
    """The dipole integrator a ``SurfaceIntegrator "dipolesubsurface"``
    ParamSet asks for (``maxerror`` is read and never used)."""
    return dp_mod.DipoleSubsurfaceIntegrator(
        max_error=p.find_one_float("maxerror", 0.05),
        min_sample_dist=p.find_one_float("minsampledistance", 0.25))


def dipole_medium(job: RenderJob, log=print, device=device_mod.DEFAULT):
    """(sigma'_s, sigma_a, sss_mask) of the job's first subsurface medium,
    the mask true on every subsurface material id; (None, None, None) when
    the job has none (the dipole then takes skin1 on every surface)."""
    if not job.sss:
        return None, None, None
    sps, sa, _eta = next(iter(job.sss.values()))
    if len(job.sss) > 1:
        log("note: multiple subsurface media; dipole uses the first")
    mask = np.zeros((job.scene.materials.n,), bool)
    for mid in job.sss:
        mask[mid] = True
    dev = device_mod.resolve(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa
                                     device=dev)
    return as_t(sps), as_t(sa), torch.from_numpy(mask).to(dev)


def build_li(job: RenderJob, log=print,
             device=device_mod.DEFAULT) -> Callable:
    """The job's radiance ``li(scene, rays, diffs, sctx)``: the surface
    integrator's, and on a scene with a volume, T * Ls + Lv with (Lv, T)
    the volume integrator's over the camera segment up to the first
    surface hit (one more closest-hit traversal of the camera rays; 1e7
    where they miss). Only that segment is attenuated: the surface
    integrator's own rays ignore the medium, as in the reference."""
    surf_li = build_surface_li(job, log=log, device=device)
    step = job.vol_params.find_one_float("stepsize", 1.0)
    if job.vol_integrator == "single":
        ig = vi_mod.SingleScatteringIntegrator(step_size=step)
        vol_li = lambda s, r, t, c: vi_mod.single_scatter_li(ig, s, r, t, c)
    else:       # "emission", the default
        ig = vi_mod.EmissionIntegrator(step_size=step)
        vol_li = lambda s, r, t, c: vi_mod.emission_li(ig, s, r, t, c)

    def li(scene, rays, diffs, sctx):
        ls = surf_li(scene, rays, diffs, sctx)
        if scene.volume is None:
            return ls
        hits = st.intersect(scene.geometry, rays)
        seg_tmax = torch.where(hits.hit, hits.t, 1e7)
        lv, tr = vol_li(scene, rays, seg_tmax, sctx)
        return tr * ls + lv

    return li


def run(job: RenderJob, progress: Optional[Callable] = None, log=print,
        stats: Optional[stats_mod.RenderStats] = None,
        device=device_mod.DEFAULT) -> np.ndarray:
    """Render `job` on `device`; returns (H, W, 3) linear RGB as numpy.

    The ``sampler`` renderer fills `stats` (a fresh one when None) with its
    waves, camera rays, seconds, the traversal queries it issued (counted
    where they are issued, ``scene.types.QUERIES``: exact with no trace) and
    the scene's size, and logs the summary. A wave that fails after the
    first returns the film of the waves before it."""
    dev = device_mod.resolve(device)
    rp = job.renderer_params
    rname = job.renderer
    if rname == "metropolis":
        return mlt_mod.render(job.scene, job.camera, job.width, job.height,
                              progress=progress, device=dev,
                              **metropolis_options(rp))
    if rname == "createprobes":
        opts, fname = createprobes_options(rp)
        pr = probes_mod.render(job.scene, build_li(job, log=log, device=dev),
                               device=dev, **opts)
        probes_mod.save(fname, pr)
        log(f"createprobes: wrote {fname}")
        return np.zeros((job.height, job.width, 3), np.float32)
    if rname == "surfacepoints":
        sp = sp_mod.render(
            job.scene,
            min_sample_dist=rp.find_one_float("minsampledistance", 0.25),
            device=dev)
        fname = rp.find_one_string("filename", "surfacepoints.npz")
        sp_mod.save(fname, sp)
        log(f"surfacepoints: wrote {fname} ({sp.p.shape[0]} points)")
        return np.zeros((job.height, job.width, 3), np.float32)
    scene = st.to_device(job.scene, dev)
    if rname == "aggregatetest":
        _aggregate_test(scene, n_iters=rp.find_one_int("niters", 100_000),
                        log=log)
        return np.zeros((job.height, job.width, 3), np.float32)
    if rname != "sampler":
        log(f"warning: unknown renderer {rname!r}; using sampler")
    li = build_li(job, log=log, device=dev)
    if job.adaptive is not None:
        mn, mx = job.adaptive
        img, n_ref = rend.render_adaptive(
            scene, job.camera, job.sampler, li, job.width, job.height,
            min_spp=mn, max_spp=mx, progress=progress,
            filter_name=job.filter_name, filter_params=job.filter_params,
            device=dev)
        log(f"adaptive: refined {n_ref} pixels to {mx} spp")
        return img
    st_ = stats if stats is not None else stats_mod.RenderStats()
    queries = st.QUERIES["rays"]
    img = rend.render(scene, job.camera, job.sampler, li, job.width,
                      job.height, progress=progress,
                      filter_name=job.filter_name,
                      filter_params=job.filter_params, stats=st_,
                      on_error="partial", log=log,
                      sampling_mode=job.sampling_mode, device=dev)
    st_.add("rays/traversal_queries", st.QUERIES["rays"] - queries)
    st_.add("scene/triangles", scene.geometry.n_prims)
    st_.add("scene/bvh_nodes", scene.geometry.n_nodes)
    log(st_.summary())
    return img


def _aggregate_test(scene, n_iters=100_000, log=print):
    """Random rays through the scene's BVH against the exhaustive
    intersector: the hit masks must be equal. Returns (rays, mismatches,
    rays with inconsistent bounds, max |dt| where both hit); raises
    AssertionError on a mismatch."""
    geom = scene.geometry
    dev = geom.v0.x.device
    wb = geom.world_bound.cpu().numpy()
    rng = np.random.default_rng(0)
    n = min(n_iters, 65536)
    o = rng.uniform(wb[0] - 0.5, wb[1] + 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
    rays = vm.make_rays(torch.from_numpy(o).to(dev),
                        torch.from_numpy(d).to(dev))
    mism, inconsistent, max_dt = aggregate_compare(geom, rays)
    log(f"aggregatetest: {n} rays, {mism} hit mismatches, "
        f"max|dt|={max_dt:.2e}, {inconsistent} with inconsistent bounds")
    if mism > 0:
        raise AssertionError(f"aggregatetest failed: {mism} mismatches")
    return n, mism, inconsistent, max_dt


def aggregate_compare(geom, rays):
    """(hit mismatches, rays with inconsistent bounds, max |dt| where both
    hit) of ``scene.types.intersect`` against the exhaustive intersector.

    As pbrt's aggregate test does, a ray whose exhaustive hit lies on a
    triangle whose own bounding box the ray misses has inconsistent bounds
    and is not held against the BVH: the intersector's inclusive
    barycentric tolerance (1e-6) accepts points just past a triangle's
    edge, outside every box the walk tests. The reference's row-packet walk
    finds such a hit only when another lane of its row opens the box; a
    ray alone, its walk misses it as the port's does."""
    h_acc = st.intersect(geom, rays)
    # chunks of triangles small enough that a (rays x chunk) step stays
    # near 2^24 lanes
    h_ref = tv.brute_force_intersect(geom.v0, geom.e1, geom.e2, rays,
                                     chunk=max(1, (1 << 24) // rays.n))
    inconsistent = misses_own_box(geom, rays, h_ref.prim)
    mism = int(((h_acc.hit != h_ref.hit) & ~inconsistent).sum())
    both = h_acc.hit & h_ref.hit
    terr = (h_acc.t - h_ref.t).abs()[both]
    return (mism, int(inconsistent.sum()),
            float(terr.max()) if terr.numel() else 0.0)


def misses_own_box(geom, rays, prim):
    """(R,) bool: the ray hit triangle `prim` (-1: none) at a point outside
    the triangle's own bounding box, within the inclusive barycentric
    tolerance: a hit no box walk need find (``aggregate_compare``)."""
    j = prim.clamp_min(0).long()
    v0, e1, e2 = (vm.to_arr(a)[j] for a in (geom.v0, geom.e1, geom.e2))
    corners = torch.stack([v0, v0 + e1, v0 + e2])
    o = vm.to_arr(rays.o)
    inv = tv.inv_dir(vm.to_arr(rays.d))
    t0 = (corners.amin(0) - o) * inv
    t1 = (corners.amax(0) - o) * inv
    tn = torch.maximum(torch.minimum(t0, t1).amax(1), rays.tmin)
    tf = torch.minimum(torch.maximum(t0, t1).amin(1), rays.tmax)
    return (prim >= 0) & ~(tn <= tf)


def render_pbrt(text_or_path: str, search_paths=None,
                progress: Optional[Callable] = None,
                overrides: Optional[dict] = None,
                log: Optional[Callable] = None,
                stats: Optional[stats_mod.RenderStats] = None,
                device=device_mod.DEFAULT) -> np.ndarray:
    """Parse and render a PBRT scene (a file, or the scene's text) on
    `device`; returns (H, W, 3) linear RGB as numpy.

    overrides: keys of ``apply_overrides``, and "spectrum" ("rgb" or
    "sampled", the global mode, set before parsing: the scene's tables are
    built in it). log: message callback; defaults to
    the leveled logger (``log.default``: "warning:" lines at WARNING, SEVERE
    raises)."""
    dev = device_mod.resolve(device)
    if log is None:
        log = log_mod.default.as_callback()
    if overrides and "spectrum" in overrides:
        spec_mod.set_mode(overrides["spectrum"])
    if os.path.exists(text_or_path):
        resolver = resources.Resolver(
            [os.path.dirname(os.path.abspath(text_or_path))]
            + list(search_paths or []))
        text = resolver(os.path.basename(text_or_path))
    else:
        resolver = resources.Resolver(list(search_paths or ["."]))
        text = text_or_path
    job = parser_mod.parse(text, resolver=resolver, log=log, device=dev)
    if overrides:
        job = apply_overrides(job, overrides, log=log)
    return run(job, progress=progress, log=log, stats=stats, device=dev)


_SAMPLING_MODES = {0: "full", 1: "twopass", 2: "iterative",
                   "full": "full", "twopass": "twopass",
                   "iterative": "iterative"}


def apply_overrides(job: RenderJob, ov: dict, log=print) -> RenderJob:
    """The render overrides: quick_render, resolution_scale / resolution,
    samplingMode, and name + params overrides of the sampler, filter,
    renderer, surfaceIntegrator, volumeIntegrator, accelerator and camera.
    Film and pixelSampler overrides are accepted and logged as no-ops. The
    camera keeps the width and height it was parsed with: a resolution
    override renders the top-left part of the parsed view, as in the
    reference."""
    if ov.get("quick_render") or ov.get("quickRender"):
        ov = {"resolution_scale": 0.25, "spp": 1, **ov}
    if "resolution_scale" in ov or "resolutionScale" in ov:
        s = float(ov.get("resolution_scale", ov.get("resolutionScale")))
        job = dataclasses.replace(job, width=max(int(job.width * s), 1),
                                  height=max(int(job.height * s), 1))
    if "resolution" in ov:
        w, h = ov["resolution"]
        job = dataclasses.replace(job, width=int(w), height=int(h))
    if "samplingMode" in ov:
        job = dataclasses.replace(
            job, sampling_mode=_SAMPLING_MODES.get(ov["samplingMode"],
                                                   "iterative"))

    def name_params(key):
        v = ov.get(key)
        if v is None:
            return None, None
        if isinstance(v, str):
            return v, ps_mod.ParamSet()
        return v.get("name"), ps_mod.ParamSet.from_json(v.get("params"))

    name, params = name_params("sampler")
    if name or "spp" in ov:
        spp = int(ov.get("spp",
                         params.find_one_int("pixelsamples", 4)
                         if params else 4))
        job = dataclasses.replace(
            job, sampler=smp_mod.make_sampler(name or "lowdiscrepancy",
                                              spp=spp))
    name, params = name_params("filter")
    if name:
        fp = {k: v[1][0] for k, v in params.items.items()} if params else {}
        job = dataclasses.replace(job, filter_name=name,
                                  filter_params=fp or None)
    name, params = name_params("surfaceIntegrator")
    if name:
        job = dataclasses.replace(job, surf_integrator=name,
                                  surf_params=params)
    name, params = name_params("volumeIntegrator")
    if name:
        job = dataclasses.replace(job, vol_integrator=name,
                                  vol_params=params)
    name, params = name_params("renderer")
    if name:
        job = dataclasses.replace(job, renderer=name, renderer_params=params)
    name, params = name_params("accelerator")
    if name:
        job = _override_accelerator(job, name, log)
    name, params = name_params("camera")
    if name:
        job = _override_camera(job, name, params, log)
    for key in ("film", "pixelSampler"):
        if key in ov:
            log(f"note: {key} override accepted but is a no-op by design "
                f"(the film is the fixed XYZW accumulator; pixel samplers "
                f"have no place in a wavefront render)")
    return job


def _override_camera(job: RenderJob, name: str, params, log=print) \
        -> RenderJob:
    """Rebuild the camera without re-parsing: the requested type over the
    parsed camera's camera-to-world transform, shutter and animated
    transform (params: fov / lensradius / focaldistance where they
    apply)."""
    old = job.camera
    pf = (lambda k, d: params.find_one_float(k, d)) if params \
        else (lambda k, d: d)
    common = dict(shutter_open=float(old.shutter_open),
                  shutter_close=float(old.shutter_close),
                  animated=old.animated, device=old.device)
    lens = lambda: dict(
        lens_radius=pf("lensradius", float(old.lens_radius)),
        focal_distance=pf("focaldistance", float(old.focal_distance)))
    if name == "perspective":
        cam = cam_mod.perspective(old.cam2world, pf("fov", 60.0), job.width,
                                  job.height, **lens(), **common)
    elif name == "orthographic":
        cam = cam_mod.orthographic(old.cam2world, job.width, job.height,
                                   **lens(), **common)
    elif name == "environment":
        cam = cam_mod.environment(old.cam2world, job.width, job.height,
                                  **common)
    else:
        log(f"warning: unknown camera override {name!r} ignored")
        return job
    return dataclasses.replace(job, camera=cam)


def _override_accelerator(job: RenderJob, name: str, log=print) -> RenderJob:
    """Accelerator override: "grid" and "kdtree" build that alternate over
    the parsed triangle soup; any other name drops the alternate (the
    cluster BVH, which every port scene has). Moving geometry ignores the
    override, as in the reference."""
    geom = job.scene.geometry
    if geom.has_motion:
        log(f"note: accelerator override {name!r} ignored for moving "
            f"geometry (grid/kdtree do not lerp vertices by ray time)")
        return job
    want = name if name in ("grid", "kdtree") else ""
    if want == geom.alt_kind:
        log(f"accelerator override {name!r}: already active")
        return job
    soup = [np.stack([np.asarray(c) for c in v], -1)
            for v in (geom.v0, geom.e1, geom.e2)]
    alt = st.build_alt(want, *soup)
    if want:
        log(f"accelerator override: rebuilt {want!r} over the parsed "
            f"triangle soup ({soup[0].shape[0]} tris)")
    else:
        log(f"accelerator override {name!r}: cluster BVH")
    geom = dataclasses.replace(geom, alt=alt, alt_kind=want)
    return dataclasses.replace(
        job, scene=dataclasses.replace(job.scene, geometry=geom))


def overrides_to_json(ov: dict) -> str:
    """Serialize an overrides dict (the render overrides' JSON form)."""
    return json.dumps(ov, sort_keys=True)


def overrides_from_json(text: str) -> dict:
    """Parse the render overrides' JSON form: this module's dict form and
    the {name, params} nesting."""
    return json.loads(text)
