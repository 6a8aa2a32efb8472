"""batch_fill.serve: the service's coalescing over the window, requests
served over batches run times the largest batch
(``RolloutService.stats``), in percent."""


def read(ctx):
    stats = ctx.get("stats") or {}
    if not stats.get("batches"):
        return None
    return 100.0 * stats["requests"] / (stats["batches"] * ctx["batch"])
