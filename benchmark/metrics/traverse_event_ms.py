"""traverse_event_ms: device ms a wave between the CUDA events at the edges
of the port's ``traverse`` spans (``scene.types.intersect``,
``intersect_pair``, ``intersect_p``: sort, kernel and finish), outermost
spans only, with no synchronisation, in the stretch traced with the port's
collector on."""
from benchmark import port_spans


def read(rec):
    return port_spans.event_ms(rec, "traverse")
