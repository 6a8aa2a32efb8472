"""Tiny configurations and cells of the benchmark's shapes, for CPU tests."""

import copy
import time

from portbench import loader  # noqa: F401

M3 = {"name": "m3", "model": "local3d", "dim": 32, "depth": 2, "heads": 1, "dim_head": 16,
      "mlp_dim": 32, "extents": [3, 1, 1], "n_past": 5, "image_size": 32, "num_digits": 2,
      "digit_size": 12, "dataset": "moving_mnist",
      "tokenizer": {"embedding_dim": 8, "num_embeddings": 16, "downscale_steps": 2,
                    "hidden_planes": 8, "in_channels": 1},
      "max_steps": 75000, "lr": 1e-4, "weight_decay": 1e-7, "warmup": 500,
      "p_max_uniform": 0.1, "ema_decay": 0.999, "bf16": False, "tok_bf16": True,
      "serve": {"num_frames": 8, "num_iterations": 6, "topk": -1, "batch_size": 4}}

SPARSE = {"name": "sparse_s32", "model": "sparse", "S": 8, "H": 8, "W": 8, "dim": 32,
          "depth": 2, "heads": 2, "mlp_dim": 32, "num_context": 64,
          "sampling_type": "neighbors", "change_batch_interval": 4, "buffer_size": 400,
          "max_segment_length": 100, "skip_frames": 2, "image_size": 32,
          "dataset": "synthetic",
          "tokenizer": {"embedding_dim": 8, "num_embeddings": 16, "downscale_steps": 2,
                        "hidden_planes": 8, "in_channels": 3},
          "max_steps": 500000, "lr": 5e-5, "weight_decay": 0.01, "warmup": 500,
          "p_max_uniform": 0.1, "ema_decay": 0.999, "bf16": False, "attn_backend": "flash"}


def cell(name: str, **traffic):
    """The benchmark's cell ``name`` with a tiny batch."""
    c = copy.deepcopy(loader.workload(name))
    c["traffic"].update(warmup_seconds=0.2, trace_seconds=0.3, **traffic)
    return c


def run_m3(seed=11, **kw):
    from portbench.runners import train_m3
    c = cell("m3.train_b64", batch_size=4, steps_per_dispatch=2)
    return train_m3.run(c, dict(M3, **kw.pop("cfg", {})), seed=seed, seconds=0.5,
                        trace=False, t0=time.perf_counter(), device="cpu", **kw)


def run_sparse(seed=11, **kw):
    from portbench.runners import train_sparse
    c = cell("sparse_s32.train_b48", batch_size=4, steps_per_dispatch=4)
    return train_sparse.run(c, dict(SPARSE, **kw.pop("cfg", {})), seed=seed, seconds=0.5,
                            trace=False, t0=time.perf_counter(), device="cpu", **kw)


def run_serve(seed=11, **kw):
    from portbench.runners import serve_m3
    c = copy.deepcopy(loader.workload("m3.serve_r80"))
    c["traffic"]["rate"] = 10.0
    c["check"]["requests"] = 4
    return serve_m3.run(c, M3, seed=seed, seconds=1.0, trace=False, t0=time.perf_counter(),
                        device="cpu", **kw)

