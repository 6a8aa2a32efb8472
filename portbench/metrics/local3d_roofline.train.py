"""local3d_roofline.train: the least time the local-3D attention's
forward and backward of the traced steps need (``counts.local3d_work`` at
the cell's shapes, per layer, in the compute dtype) over the device time
of the kernels named ``local3d``, in percent."""

from portbench.metrics import counts


def read(ctx):
    sl, cfg = ctx["trace"], ctx["config"]
    seconds = sl.kernel_seconds("local3d") if sl is not None else 0.0
    if seconds <= 0 or sl.units == 0:
        return None
    grid = cfg["image_size"] // 2 ** cfg["tokenizer"]["downscale_steps"]
    work = counts.local3d_work(ctx["batch"], (cfg["n_past"] + 1, grid, grid), cfg["heads"],
                               cfg["dim_head"], tuple(cfg["extents"]), 2)
    per_layer = sum(counts.bound_seconds(b, f, ctx["kind"], "bf16") for b, f in work.values())
    return 100.0 * sl.units * cfg["depth"] * per_layer / seconds
