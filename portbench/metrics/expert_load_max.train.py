"""expert_load_max.train: the most loaded held expert's assignments over
the held experts' mean (the most loaded layer's, averaged over the steps
whose stats the traced slice read: the program's counters
``moe.load_max_milli`` and ``moe.steps``), in percent. 100 is even
routing."""


def read(ctx):
    if ctx["trace"] is None:
        return None
    try:
        from world_modelz_tpu_torch.utils import tracing
    except ImportError:  # a program without the recorder
        return None
    found = tracing.collect().counters
    if not found.get("moe.steps"):
        return None
    return 0.1 * found["moe.load_max_milli"] / found["moe.steps"]
