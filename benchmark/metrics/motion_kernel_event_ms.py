"""motion_kernel_event_ms: device ms a wave between the CUDA events at the
edges of the port's ``kernel`` spans tagged ``motion`` (the launches of
the traversal kernel's motion instantiation, ``ops/traverse_cuda.py``), in
the stretch traced with the port's collector on. Nothing where the port
tags no span so (a static scene, or a port without the tag)."""


def read(rec):
    port = getattr(rec, "port", None)
    if not port:
        return None
    got = [s["device_ms"] for s in port["spans"]
           if s["name"] == "kernel" and s.get("attrs", {}).get("motion")
           and "device_ms" in s]
    return sum(got) / port["units"] if got else None
