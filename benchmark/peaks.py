"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W power limit) that the roofline shares divide by."""

H100 = {
    "hbm_bytes_per_s": 3.35e12,
}
