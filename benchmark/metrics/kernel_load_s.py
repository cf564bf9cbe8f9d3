"""kernel_load_s: the span around ops.traverse_cuda.load_kernels; long
where the kernel cache missed and nvcc ran."""


def read(rec):
    return rec.spans.get("kernel_load")
