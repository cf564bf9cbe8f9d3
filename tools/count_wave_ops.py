"""Count the host operations one path wave issues, on the CPU.

    python tools/count_wave_ops.py [--res 16]

The bench scene (bench.py's, depth 5) at a small resolution in three
configurations of ``chip_smoke.py``'s ``sampling_path``: the main path's
(lowdiscrepancy, box), (b1) stratified 8x8 with the mitchell filter and
(b2) the environment camera with halton and the gaussian filter in the
sampled spectrum mode. The traversal is stubbed out (every ray misses), so
the count is the wave's own operations around it, not the plain traversal's
loop; the wave's code is branch-free, so the count does not depend on what
the rays hit. Prints one JSON object: ``aten`` operations a wave (views and
other metadata-only operations left out) per configuration. A count made
here predicts the card's device kernels a wave; it is not a device number.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from dartray_tpu_torch import cameras, samplers  # noqa: E402
from dartray_tpu_torch import film as film_mod  # noqa: E402
from dartray_tpu_torch.core import spectrum  # noqa: E402
from dartray_tpu_torch.core import transform as tr  # noqa: E402
from dartray_tpu_torch.integrators import path as pi  # noqa: E402
from dartray_tpu_torch.ops import traverse_cuda as tc  # noqa: E402
from dartray_tpu_torch.renderers import sampler as rend  # noqa: E402
from dartray_tpu_torch.scene import build as sb  # noqa: E402
from dartray_tpu_torch.scene import types as st  # noqa: E402

# operations that move no data
METADATA = {"aten::empty", "aten::empty_strided", "aten::view",
            "aten::as_strided", "aten::expand", "aten::select", "aten::slice",
            "aten::unsqueeze", "aten::alias", "aten::detach", "aten::t",
            "aten::transpose", "aten::reshape", "aten::_reshape_alias",
            "aten::resize_", "aten::lift_fresh", "aten::result_type",
            "aten::item", "aten::_local_scalar_dense", "aten::squeeze",
            "aten::unbind", "aten::broadcast_tensors", "aten::is_nonzero"}


def all_miss(bvh, o, d, tmin, tmax, *, any_hit=False, anyf=None, time=None):
    n = tmin.shape[0]
    return (torch.full((n,), float("inf")),
            torch.full((n,), -1, dtype=torch.int32))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--res", type=int, default=16)
    res = ap.parse_args().res
    torch.set_num_threads(1)
    tc.traverse6 = all_miss
    scene = st.to_device(sb.bench_scene().build(), "cpu")
    c2w = tr.look_at([0, 2.2, -5.0], [0, 0.9, 0], [0, 1, 0])
    configs = {
        "main": (cameras.perspective(c2w, 42.0, res, res, device="cpu"),
                 samplers.make_sampler("lowdiscrepancy", 64), "box", "rgb"),
        "b1": (cameras.perspective(c2w, 42.0, res, res, device="cpu"),
               samplers.make_sampler("stratified", 64), "mitchell", "rgb"),
        "b2": (cameras.environment(c2w, res, res, device="cpu"),
               samplers.make_sampler("halton", 64), "gaussian", "sampled"),
    }
    ig = pi.PathIntegrator(max_depth=5)
    px, py = rend.pixel_grid(res, res, device="cpu")
    out = {}
    for name, (cam, smp, filt, mode) in configs.items():
        spectrum.set_mode(mode)
        film = film_mod.make_film(res, res, filter_name=filt, device="cpu")

        def wave():
            with torch.no_grad():
                rend.render_wave(
                    scene, cam, smp, film, px, py,
                    torch.full(px.shape, 1, dtype=torch.int32),
                    li_fn=lambda s, r, d, c: pi.li(ig, s, r, d, c),
                    width=res, height=res, spp=smp.spp, device="cpu")
        wave()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            wave()
        out[name] = sum(e.count for e in prof.key_averages()
                        if e.key.startswith("aten::")
                        and e.key not in METADATA)
    spectrum.set_mode("rgb")
    print(json.dumps({"res": res, "aten_ops_a_wave": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
