"""device_idle_share.train: the share of the traced slice in which no
operation ran on the card (rank 0's card), in percent."""


def read(ctx):
    sl = ctx["trace"]
    if sl is None or sl.window_s <= 0 or not sl.kernels:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
