"""Direct lighting over every light (strategy "all") with specular
continuations to ``maxdepth``: the port's ``integrators/direct.py`` and the
reference's ``reference.integrators.direct``."""
from benchmark.reference import integrators as ref


def _strategy_all(params):
    if params.get("strategy", "all") != "all":
        raise ValueError("the reference's direct lighting samples every "
                         "light (strategy all)")


def program(params):
    from dartray_tpu_torch.integrators import direct
    _strategy_all(params)
    ig = direct.DirectLightingIntegrator(max_depth=params["maxdepth"])
    return lambda s, r, d, c: direct.li(ig, s, r, d, c)


def reference(params):
    _strategy_all(params)
    return lambda sc, cam, lanes, kd=None: ref.direct(
        sc, cam, lanes, max_depth=params["maxdepth"])
