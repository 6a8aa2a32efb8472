"""step_mfu.train: the training step's model FLOPs (``counts.
model_step_flops``: forward x 3, local-3D attention over the window's
pairs) times the steps per second of the traced slice, over the bf16 peak
of every card the cell uses, in percent."""

from portbench.metrics import counts


def read(ctx):
    sl = ctx["trace"]
    if sl is None or sl.units == 0 or sl.window_s <= 0:
        return None
    flops = counts.model_step_flops(ctx["config"], ctx["batch"] * ctx["chips"])
    peak = counts.peaks(ctx["kind"])["bf16_flops"] * ctx["chips"]
    return 100.0 * flops * sl.units / sl.window_s / peak
