"""bd_step_mfu.train: the block-diffusion step's model FLOPs (``bd_counts.
step_flops``: forward x 3, attention over the mask's allowed pairs, the
held experts' assignments as the program counted them in the traced
steps) times the steps per second of the traced slice, over the card's
bf16 peak, in percent."""

from portbench.metrics import bd_counts, counts


def read(ctx):
    sl = ctx["trace"]
    held = bd_counts.traced_held_assignments()
    if sl is None or sl.units == 0 or sl.window_s <= 0 or held is None:
        return None
    flops = bd_counts.step_flops(ctx["config"], ctx["batch"], ctx["cell"]["traffic"]["seq_len"],
                                 held)
    return 100.0 * flops * sl.units / sl.window_s / counts.peaks(ctx["kind"])["bf16_flops"]
