"""wave_enqueue_ms: median host time from the call of render_wave to its
return, without a synchronisation inside (the traced run's waves)."""
import statistics


def read(rec):
    if rec.mode != "render" or not rec.enqueue_s:
        return None
    return statistics.median(rec.enqueue_s) * 1e3
