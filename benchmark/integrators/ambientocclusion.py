"""Ambient occlusion with ``nsamples`` probes a camera hit: the port's
``integrators/ao.py`` and the reference's
``reference.integrators.ambient_occlusion``."""
from benchmark.reference import integrators as ref


def program(params):
    from dartray_tpu_torch.integrators import ao
    ig = ao.AOIntegrator(n_samples=params["nsamples"])
    return lambda s, r, d, c: ao.li(ig, s, r, d, c)


def reference(params):
    return lambda sc, cam, lanes, kd=None: ref.ambient_occlusion(
        sc, cam, lanes, n_samples=params["nsamples"])
