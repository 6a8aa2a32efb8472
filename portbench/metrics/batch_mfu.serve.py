"""batch_mfu.serve: model FLOPs of the clips served by the rollout calls
that lie wholly inside the traced slice (``counts.serve_clip_flops``) over
the device's busy time inside those calls, against the card's f32 peak
(the artifact computes in f32 with TF32 off), in percent. The base is the
device's busy time, not the window: at a fixed offered rate the clips a
window serves cannot move."""

from portbench.metrics import counts


def read(ctx):
    sl = ctx["trace"]
    if sl is None or not getattr(sl, "batches", None):
        return None
    busy = sl.kernel_seconds(between=[(r["t0"], r["t1"]) for r in sl.batches])
    if busy <= 0:
        return None
    flops = counts.serve_clip_flops(ctx["config"]) * sum(r["n"] for r in sl.batches)
    return 100.0 * flops / busy / counts.peaks(ctx["kind"])["f32_flops"]
