"""flash_roofline.train: the least time the dense attention's forward and
backward of the traced steps need (``counts.flash_work`` at the cell's
shapes, per layer, bf16) over the device time of the kernels named
``flash_``, in percent."""

from portbench.metrics import counts


def read(ctx):
    sl, cfg = ctx["trace"], ctx["config"]
    seconds = sl.kernel_seconds("flash_") if sl is not None else 0.0
    if seconds <= 0 or sl.units == 0:
        return None
    heads = cfg["heads"]
    work = counts.flash_work(ctx["batch"], heads, cfg["num_context"], cfg["dim"] // heads, 2)
    per_layer = sum(counts.bound_seconds(b, f, ctx["kind"], "bf16") for b, f in work.values())
    return 100.0 * sl.units * cfg["depth"] * per_layer / seconds
