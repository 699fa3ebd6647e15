"""Deterministic, seekable synthetic token pipeline.

Restart safety by construction: batch ``i`` is a pure function of
``(seed, i)`` (counter-based Philox), so resuming from a checkpoint at step
``k`` replays *exactly* the remaining stream with no state file — the same
"plan is cached with the matrix" philosophy the paper applies to partitions.

Token statistics are Zipf-like (realistic embedding-gather locality), with
document boundaries so sequences have the structure LMs expect.

The port's copy of ``src/repro/data/pipeline.py`` (numpy only): every
batch and frame array is byte for byte the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512
    bos_id: int = 1

    def batch_at(self, step: int) -> np.ndarray:
        """(global_batch, seq_len) int32 for this step — pure function."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, 0, step]))
        shape = (self.global_batch, self.seq_len)
        # Zipf-like ids via inverse-CDF on a pareto-ish transform
        u = rng.random(shape)
        ranks = np.minimum((u ** (-1.0 / (self.zipf_a - 1.0)) - 1.0)
                           .astype(np.int64), self.vocab - 2)
        toks = (ranks % (self.vocab - 2)) + 2
        # document boundaries
        doc_break = rng.random(shape) < (1.0 / self.mean_doc_len)
        toks = np.where(doc_break, self.bos_id, toks)
        toks[:, 0] = self.bos_id
        return toks.astype(np.int32)

    def frames_at(self, step: int, n_frames: int, d_model: int,
                  dtype=np.float32) -> np.ndarray:
        """Stub modality frontend: deterministic (B, frames, d) embeddings."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed + 1, counter=[0, 0, 0, step]))
        return rng.standard_normal(
            (self.global_batch, n_frames, d_model)).astype(dtype) * 0.02
