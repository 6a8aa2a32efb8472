"""coalesce_idle_share.serve: the device's idle time inside the traced
slice charged to the service's ``serve.coalesce`` span (the worker holding
a batch open for more requests, ``serve.py:RolloutService``), over the
slice, in percent."""

from portbench import spans


def read(ctx):
    sl = ctx["trace"]
    prog = spans.view(sl)
    if prog is None or not prog.named("serve.coalesce") or sl.window_s <= 0:
        return None
    return 100.0 * prog.idle_under("serve.coalesce") / sl.window_s
