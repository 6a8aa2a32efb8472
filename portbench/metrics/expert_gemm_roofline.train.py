"""expert_gemm_roofline.train: the least time the held experts' grouped
GEMMs of the traced steps need (``bd_counts.expert_work`` of the
assignments the program counted in them, ``bd_counts.
traced_held_assignments``, an even share a layer, bf16; the backward's
recomputed forward not counted) over the device time of the kernels named
``expert_gemm_``, in percent."""

from portbench.metrics import bd_counts


def read(ctx):
    sl, cfg = ctx["trace"], ctx["config"]
    seconds = sl.kernel_seconds("expert_gemm_") if sl is not None else 0.0
    held = bd_counts.traced_held_assignments()
    if seconds <= 0 or sl.units == 0 or held is None:
        return None
    layers = cfg["num_hidden_layers"]
    per_layer = bd_counts.bound_seconds(bd_counts.expert_work(cfg, held / layers), ctx["kind"])
    return 100.0 * sl.units * layers * per_layer / seconds
