"""queue_wait_ms.serve: the median wait in the service's queue, from a
request's enqueue to the close of the batch that takes it (the program's
``serve.queue`` spans), of the requests whose batch closed inside the
traced slice, in ms."""

from portbench import spans


def read(ctx):
    prog = spans.view(ctx["trace"])
    return None if prog is None else prog.median_ms("serve.queue", "end")
