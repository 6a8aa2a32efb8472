"""encode_idle_share.train: the device's idle time inside the traced slice
charged to the program's ``sparse.encode`` span (the sparse trainer's eager
encode of a fresh volume batch, ``cli/sparse_diffusion.py:encode_batch``)
and to the spans under it, over the slice, in percent."""

from portbench import spans


def read(ctx):
    sl = ctx["trace"]
    prog = spans.view(sl)
    if prog is None or not prog.named("sparse.encode") or sl.window_s <= 0:
        return None
    return 100.0 * prog.idle_under("sparse.encode") / sl.window_s
