"""samples_per_s: camera samples deposited into the film over the whole
window, divided by the window's seconds (render cells)."""


def read(rec):
    if rec.mode != "render" or rec.window_s <= 0:
        return None
    return rec.samples / rec.window_s
