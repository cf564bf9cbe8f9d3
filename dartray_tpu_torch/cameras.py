"""Cameras: vectorized ray generation (counterpart of the JAX reference's
``cameras.py``).

A camera is a plain dataclass of host matrices and scalars;
``generate_rays`` maps a whole wavefront of CameraSamples to world-space rays
in one shot, including depth-of-field lens sampling and ray differentials
(the +1 pixel x/y rays, pre-scaled by 1/sqrt(spp)).

Kinds: perspective, orthographic (both with depth of field) and the
latitude-longitude environment camera. An animated camera-to-world transform
is stored in ``Camera.animated`` and never applied: rays leave through the
shutter-open transform ``cam2world``, as in the reference (ROADMAP known
behaviour p).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import device as device_mod
from .core import math as vm
from .core import sampling as smp
from .core import transform as tr
from .samplers import CameraSamples  # noqa: F401  (re-export, as upstream)

PERSPECTIVE = 0
ORTHOGRAPHIC = 1
ENVIRONMENT = 2


@dataclasses.dataclass
class Camera:
    """All fields live on the host: the matrices enter the wavefront math as
    scalars. `device` is where ``generate_rays`` expects its samples."""
    kind: int
    cam2world: tr.Transform        # world from camera
    raster2camera: np.ndarray      # (4, 4) f32
    dx_camera: np.ndarray          # (3,) raster-x step in camera space
    dy_camera: np.ndarray          # (3,)
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    device: torch.device = torch.device("cpu")
    animated: tr.AnimatedTransform = None   # stored, never applied


def _raster_to_screen(width, height, screen_window):
    x0, x1, y0, y1 = screen_window
    # raster (0..w, 0..h) -> screen (x0..x1, y1..y0)
    s = tr.scale((x1 - x0) / width, (y0 - y1) / height, 1.0)
    t = tr.translate([x0, y1, 0.0])
    return t * s


def default_screen_window(width, height):
    """pbrt convention: [-1,1] along the shorter axis."""
    aspect = width / height
    if aspect > 1.0:
        return (-aspect, aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)


def _f32(v):
    return float(np.float32(v))


def perspective(cam2world: tr.Transform, fov_deg: float, width: int,
                height: int, lens_radius=0.0, focal_distance=1e30,
                shutter_open=0.0, shutter_close=1.0, screen_window=None,
                animated=None, device=device_mod.DEFAULT) -> Camera:
    """Perspective camera (defaults: lensradius 0, focaldistance 1e30,
    shutter [0,1])."""
    dev = device_mod.resolve(device)
    if screen_window is None:
        screen_window = default_screen_window(width, height)
    cam2screen = tr.perspective(fov_deg, 1e-2, 1000.0)
    screen2camera = cam2screen.inverse()
    r2s = _raster_to_screen(width, height, screen_window)
    raster2camera = (screen2camera.m @ r2s.m).astype(np.float32)

    # camera-space differentials per raster pixel step
    def r2c(p):
        q = raster2camera @ np.asarray([p[0], p[1], 0.0, 1.0], np.float32)
        return q[:3] / q[3]
    o = r2c((0.0, 0.0))
    dx = r2c((1.0, 0.0)) - o
    dy = r2c((0.0, 1.0)) - o
    return Camera(PERSPECTIVE, cam2world, raster2camera, dx, dy,
                  _f32(lens_radius), _f32(focal_distance), _f32(shutter_open),
                  _f32(shutter_close), dev, animated)


def orthographic(cam2world: tr.Transform, width: int, height: int,
                 lens_radius=0.0, focal_distance=1e30, shutter_open=0.0,
                 shutter_close=1.0, screen_window=None, animated=None,
                 device=device_mod.DEFAULT) -> Camera:
    """Orthographic camera: parallel rays along camera +z from the raster
    point on the screen window."""
    dev = device_mod.resolve(device)
    if screen_window is None:
        screen_window = default_screen_window(width, height)
    cam2screen = tr.orthographic(0.0, 1.0)
    r2s = _raster_to_screen(width, height, screen_window)
    raster2camera = (cam2screen.inverse().m @ r2s.m).astype(np.float32)
    return Camera(ORTHOGRAPHIC, cam2world, raster2camera,
                  np.asarray([1.0, 0, 0], np.float32),
                  np.asarray([0, 1.0, 0], np.float32), _f32(lens_radius),
                  _f32(focal_distance), _f32(shutter_open),
                  _f32(shutter_close), dev, animated)


def environment(cam2world: tr.Transform, width: int, height: int,
                shutter_open=0.0, shutter_close=1.0, animated=None,
                device=device_mod.DEFAULT) -> Camera:
    """Latitude-longitude sphere camera: x is the azimuth, y the polar
    angle from camera +y."""
    dev = device_mod.resolve(device)
    return Camera(ENVIRONMENT, cam2world, np.eye(4, dtype=np.float32),
                  np.asarray([2.0 * np.pi / width, 0, 0], np.float32),
                  np.asarray([0, np.pi / height, 0], np.float32), 0.0,
                  _f32(1e30), _f32(shutter_open), _f32(shutter_close), dev,
                  animated)


class RayDiffs(NamedTuple):
    """Ray differentials: origins/directions of the +1px x/y rays, world
    space, pre-scaled by 1/sqrt(spp). All fields V3."""
    rx_o: vm.V3
    rx_d: vm.V3
    ry_o: vm.V3
    ry_d: vm.V3


def generate_rays(cam: Camera, samples: CameraSamples, width: int,
                  height: int, diff_scale: float = 1.0):
    """CameraSamples -> (Rays, RayDiffs, weight), component-SoA end to end.
    The rays leave through ``cam2world`` (an animated transform is not
    applied)."""
    img = vm.from_arr2(samples.image_xy)
    r = img.x.shape[0]
    dev = img.x.device
    time = vm.lerp(samples.time_u, cam.shutter_open, cam.shutter_close)
    c2w = cam.cam2world.m
    xf_p = lambda p: vm.xform_point3(c2w, p)
    xf_v = lambda v: vm.xform_vector3(c2w, v)
    if cam.kind == ENVIRONMENT:
        theta = np.pi * img.y / height
        phi = 2.0 * np.pi * img.x / width
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        d = vm.V3(sin_t * torch.cos(phi), cos_t, sin_t * torch.sin(phi))
        # differentials: the directions of the neighbouring pixels
        theta_y = np.pi * (img.y + 1.0) / height
        phi_x = 2.0 * np.pi * (img.x + 1.0) / width
        dx = vm.V3(sin_t * torch.cos(phi_x), cos_t, sin_t * torch.sin(phi_x))
        dy = vm.V3(torch.sin(theta_y) * torch.cos(phi), torch.cos(theta_y),
                   torch.sin(theta_y) * torch.sin(phi))
        o_w = xf_p(vm.v3zeros((r,), dev))
        d_w = xf_v(d)
        rays = vm.make_rays(o_w, d_w, tmin=0.0, time=time)
        diffs = RayDiffs(o_w, xf_v(dx) * diff_scale + d_w * (1 - diff_scale),
                         o_w, xf_v(dy) * diff_scale + d_w * (1 - diff_scale))
        return rays, diffs, torch.ones((r,), dtype=torch.float32, device=dev)

    # projective cameras: raster -> camera (homogeneous, z=0 plane)
    m = cam.raster2camera
    f = lambda i, j: float(m[i, j])
    hx = f(0, 0) * img.x + f(0, 1) * img.y + f(0, 3)
    hy = f(1, 0) * img.x + f(1, 1) * img.y + f(1, 3)
    hz = f(2, 0) * img.x + f(2, 1) * img.y + f(2, 3)
    hw = f(3, 0) * img.x + f(3, 1) * img.y + f(3, 3)
    inv_w = 1.0 / hw
    p_cam = vm.V3(hx * inv_w, hy * inv_w, hz * inv_w)

    if cam.kind == PERSPECTIVE:
        o = vm.v3zeros((r,), dev)
        d = vm.normalize(p_cam)
        dxc, dyc = cam.dx_camera, cam.dy_camera
        dx_dir = vm.normalize(p_cam + vm.V3(float(dxc[0]), float(dxc[1]),
                                            float(dxc[2])))
        dy_dir = vm.normalize(p_cam + vm.V3(float(dyc[0]), float(dyc[1]),
                                            float(dyc[2])))
    else:   # ORTHOGRAPHIC
        o = p_cam
        zf = torch.zeros((r,), dtype=torch.float32, device=dev)
        d = vm.V3(zf, zf, torch.ones((r,), dtype=torch.float32, device=dev))
        dx_dir = dy_dir = d

    # depth of field: sample the lens, refocus through the focal plane
    lr = cam.lens_radius
    if lr > 0.0:
        lx, ly = smp.concentric_sample_disk(samples.lens_uv)
        ft = cam.focal_distance / torch.abs(d.z).clamp_min(1e-12)
        p_focus = o + d * ft
        o = o + vm.V3(lx * lr, ly * lr, torch.zeros_like(lx))
        d = vm.normalize(p_focus - o)

    o_w = xf_p(o)
    d_w = xf_v(d)
    rays = vm.make_rays(o_w, d_w, time=time)
    rx_d = xf_v(dx_dir)
    ry_d = xf_v(dy_dir)
    # scaled differentials: d + scale * (d_offset - d)
    diffs = RayDiffs(o_w, d_w + (rx_d - d_w) * diff_scale,
                     o_w, d_w + (ry_d - d_w) * diff_scale)
    return rays, diffs, torch.ones((r,), dtype=torch.float32, device=dev)
