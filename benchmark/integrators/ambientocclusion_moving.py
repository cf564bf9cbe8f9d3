"""Ambient occlusion over a moving scene, ``nsamples`` probes a camera hit,
each at its camera ray's shutter time: the port's ``integrators/ao.py``
(the same ``li`` as a static scene's: the rays carry their time) and the
reference's ``reference.motion.ambient_occlusion``, which needs the
moving reference scene (``reference.motion.Scene``)."""
from benchmark.reference import motion as ref


def program(params):
    from dartray_tpu_torch.integrators import ao
    ig = ao.AOIntegrator(n_samples=params["nsamples"])
    return lambda s, r, d, c: ao.li(ig, s, r, d, c)


def reference(params):
    return lambda sc, cam, lanes, kd=None: ref.ambient_occlusion(
        sc, cam, lanes, n_samples=params["nsamples"])
