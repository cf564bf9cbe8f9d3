"""sampler_device_ms: device ms a wave between the CUDA events at the edges
of the port's ``sample`` spans (the samplers' integer hashing:
``samplers.sample_1d``, ``sample_2d``, ``camera_samples`` and the AO
probes' scrambles), outermost spans only, in the stretch traced with the
port's collector on."""
from benchmark import port_spans


def read(rec):
    return port_spans.event_ms(rec, "sample")
