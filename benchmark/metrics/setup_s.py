"""setup_s: seconds from the start of the process to the first timed unit
(imports, CUDA context, scene build and upload, kernel load, warm-up)."""


def read(rec):
    return rec.setup_s
