"""Deterministic sample-id-addressed data pipeline (pure numpy).

A copy of ``repro.data.pipeline``'s sampler and token hash: **any rank can
materialize any sample by its global id**, so micro-batch resizing re-slices
the *same* global batch instead of changing it.  Tokens are a keyed hash of
(sample_id, position), a stand-in for an indexed tokenized corpus.
:func:`make_batch` puts a batch of them on a device for the whole-model
launcher (``launch/train.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GlobalBatchSampler:
    """step -> global sample ids; slicing helpers for DP assignment."""
    global_batch: int
    seed: int = 0

    def sample_ids(self, step: int) -> np.ndarray:
        # contiguous ids: one epoch-free infinite stream
        start = step * self.global_batch
        return np.arange(start, start + self.global_batch, dtype=np.int64)

    def partition(self, step: int, micro_batch_sizes: Sequence[int],
                  num_micro_batches: int) -> List[List[np.ndarray]]:
        """Split the global batch among DP ranks x micro-batches.

        micro_batch_sizes[r] = per-micro-batch size of DP rank r (dataflow
        resizing makes these uneven after a failure).
        Returns ids[r][m] = sample ids of rank r's m-th micro batch.
        """
        ids = self.sample_ids(step)
        total = sum(micro_batch_sizes) * num_micro_batches
        assert total == self.global_batch, (total, self.global_batch)
        out: List[List[np.ndarray]] = [[] for _ in micro_batch_sizes]
        cursor = 0
        for m in range(num_micro_batches):
            for r, sz in enumerate(micro_batch_sizes):
                out[r].append(ids[cursor:cursor + sz])
                cursor += sz
        return out


def materialize_samples(sample_ids: np.ndarray, seq_len: int,
                        vocab_size: int, seed: int = 0) -> np.ndarray:
    """Deterministic tokens for given sample ids: [n, seq_len] int32."""
    sample_ids = np.asarray(sample_ids, dtype=np.uint64)
    pos = np.arange(seq_len, dtype=np.uint64)[None, :]
    x = sample_ids[:, None] * np.uint64(6364136223846793005) \
        + pos * np.uint64(1442695040888963407) + np.uint64(seed)
    # splitmix64 finalizer
    x ^= x >> np.uint64(30); x *= np.uint64(0xbf58476d1ce4e5b9)
    x ^= x >> np.uint64(27); x *= np.uint64(0x94d049bb133111eb)
    x ^= x >> np.uint64(31)
    return (x % np.uint64(vocab_size)).astype(np.int32)


def make_batch(sample_ids: np.ndarray, seq_len: int, vocab_size: int,
               seed: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """The batch of ``sample_ids`` on ``device`` (None: the card; raises
    without one): ``tokens`` and ``labels`` [n, seq_len] int64, the
    reference's int32 values as the index dtype torch's embedding lookup
    and gathers take; ``sample_ids`` [n] int32, as the reference's (the
    dtype ``RngCtx.sample_ids`` addresses dropout with)."""
    from repro_torch.core.cluster import resolve_device
    dev = resolve_device(device)
    toks = torch.from_numpy(materialize_samples(
        sample_ids, seq_len, vocab_size, seed).astype(np.int64)).to(dev)
    return {"tokens": toks, "labels": toks,
            "sample_ids": torch.from_numpy(
                np.asarray(sample_ids, dtype=np.int32)).to(dev)}
