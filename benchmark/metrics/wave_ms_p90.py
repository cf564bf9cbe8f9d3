"""wave_ms_p90: 90th percentile of the time of a wave, each wave
synchronised (the traced run's waves)."""
import statistics


def read(rec):
    if rec.mode != "render" or len(rec.unit_s) < 2:
        return None
    return statistics.quantiles(rec.unit_s, n=10)[-1] * 1e3
