"""grad_peak_mem_gib: torch.cuda.max_memory_allocated() over the window of
a gradient cell, reset at its start, in GiB."""


def read(rec):
    if rec.mode != "grad" or rec.peak_mem_bytes <= 0:
        return None
    return rec.peak_mem_bytes / 2 ** 30
