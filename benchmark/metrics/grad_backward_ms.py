"""grad_backward_ms: device time a step of the kernels that ran inside the
benchmark's synchronised range around the backward pass
(torch.autograd.grad inside grad.render_loss_grad, the checkpoints'
recomputes included)."""
from benchmark import tracing


def read(rec):
    s = rec.split
    if rec.mode != "grad" or s is None or s.get("range") != "backward":
        return None
    ranges = [r for r in s["ranges"] if r[0] == tracing.PREFIX + "backward"]
    kern = tracing.inside(s["device"], ranges)
    if not kern:
        return None
    return sum(b - a for _, a, b in kern) / s["units"] * 1e3
