"""batch_run_ms.serve: the median run of the service's batches, from a
batch's close to its last future resolved (the program's ``serve.batch``
spans: encode, rollout and finish), of the batches that closed inside the
traced slice, in ms."""

from portbench import spans


def read(ctx):
    prog = spans.view(ctx["trace"])
    return None if prog is None else prog.median_ms("serve.batch", "start")
