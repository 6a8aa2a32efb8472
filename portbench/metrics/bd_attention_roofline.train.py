"""bd_attention_roofline.train: the least time the block-diffusion GQA
attention's forward and backward of the traced steps need (``bd_counts.
attention_work``, per layer, bf16) over the device time of the kernels
named ``bdflash_``, in percent."""

from portbench.metrics import bd_counts


def read(ctx):
    sl, cfg = ctx["trace"], ctx["config"]
    seconds = sl.kernel_seconds("bdflash_") if sl is not None else 0.0
    if seconds <= 0 or sl.units == 0:
        return None
    work = bd_counts.attention_work(cfg, ctx["batch"], ctx["cell"]["traffic"]["seq_len"])
    per_layer = bd_counts.bound_seconds(work, ctx["kind"])
    return 100.0 * sl.units * cfg["num_hidden_layers"] * per_layer / seconds
