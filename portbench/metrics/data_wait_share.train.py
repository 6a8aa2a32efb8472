"""data_wait_share.train: the device's idle time inside the traced slice
charged to the program's ``data.wait`` span (the trainer blocked on the
prefetch queue, ``data/prefetch.py``), over the slice, in percent."""

from portbench import spans


def read(ctx):
    sl = ctx["trace"]
    prog = spans.view(sl)
    if prog is None or not prog.named("data.wait") or sl.window_s <= 0:
        return None
    return 100.0 * prog.idle_under("data.wait") / sl.window_s
