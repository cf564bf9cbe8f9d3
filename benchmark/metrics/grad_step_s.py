"""grad_step_s: the window divided by the whole gradient steps completed in
it; the window ends at the first step boundary after its seconds."""


def read(rec):
    if rec.mode != "grad" or rec.units == 0:
        return None
    return rec.window_s / rec.units
