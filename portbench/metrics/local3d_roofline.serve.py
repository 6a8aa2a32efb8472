"""local3d_roofline.serve: the least time the local-3D attention forwards
of the rollout calls wholly inside the traced slice need
(``counts.local3d_work`` at each call's ladder size, f32, every layer of
every unmask step) over the device time of the kernels named ``local3d``
inside those calls, in percent."""

from portbench.metrics import counts


def read(ctx):
    sl, cfg = ctx["trace"], ctx["config"]
    if sl is None or not getattr(sl, "batches", None):
        return None
    seconds = sl.kernel_seconds("local3d", between=[(r["t0"], r["t1"]) for r in sl.batches])
    if seconds <= 0:
        return None
    grid = cfg["image_size"] // 2 ** cfg["tokenizer"]["downscale_steps"]
    shape = (cfg["n_past"] + 1, grid, grid)
    sv = cfg["serve"]
    bound = 0.0
    for r in sl.batches:
        b, f = counts.local3d_work(r["b"], shape, cfg["heads"], cfg["dim_head"],
                                   tuple(cfg["extents"]), 4)["fwd"]
        bound += counts.bound_seconds(b, f, ctx["kind"], "f32")
    steps = sv["num_frames"] * sv["num_iterations"]
    return 100.0 * bound * steps * cfg["depth"] / seconds
