"""A seeded stream of packed synthetic documents, for the block-diffusion
trainer (``cli/block_diffusion.py``): the repository holds no text corpus.

Each row of a (B, L) batch is filled with documents end to end, each
followed by the end-of-document id, the last cut at the row's end. A
document's length is log-normal (median ``median``, sigma ``sigma``), at
least 1 and at most ``max_len``; its ids are drawn Zipf(``zipf``) over
``vocab`` ids: id r - 1 with probability proportional to r^-zipf.
"""

from __future__ import annotations

import numpy as np

from world_modelz_tpu_torch.utils import tracing


class PackedDocuments:
    """``sample_batch(b)`` -> (b, seq_len) int64 ids in [0, vocab], vocab
    itself the end-of-document id."""

    def __init__(self, seq_len: int, vocab: int, seed: int, median: float = 1024.0,
                 sigma: float = 1.0, max_len: int = 4096, zipf: float = 1.1):
        self.seq_len, self.vocab, self.max_len = seq_len, vocab, max_len
        self.mu, self.sigma = float(np.log(median)), sigma
        self.rng = np.random.default_rng(seed)
        cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -zipf)
        self.cdf = cdf / cdf[-1]

    def sample_batch(self, b: int) -> np.ndarray:
        with tracing.span("data.pack"):
            out = np.empty((b, self.seq_len), dtype=np.int64)
            for row in out:
                at = 0
                while at < self.seq_len:
                    n = int(np.clip(np.rint(self.rng.lognormal(self.mu, self.sigma)), 1,
                                    self.max_len))
                    n = min(n, self.seq_len - at)
                    ids = np.searchsorted(self.cdf, self.rng.random(n), side="right")
                    row[at:at + n] = np.minimum(ids, self.vocab - 1)
                    at += n
                    if at < self.seq_len:
                        row[at] = self.vocab
                        at += 1
            return out
