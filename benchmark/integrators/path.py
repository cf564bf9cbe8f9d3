"""Path tracing with next-event estimation and MIS, to ``maxdepth``
bounces: the port's ``integrators/path.py`` and the reference's
``reference.integrators.path``."""
from benchmark.reference import integrators as ref


def program(params):
    from dartray_tpu_torch.integrators import path as pi
    ig = pi.PathIntegrator(max_depth=params["maxdepth"])
    return lambda s, r, d, c: pi.li(ig, s, r, d, c)


def reference(params):
    return lambda sc, cam, lanes, kd=None: ref.path(
        sc, cam, lanes, max_depth=params["maxdepth"], kd_table=kd)
