"""Data pipeline with deterministic BMMC affine shuffling (the counterpart
of :mod:`repro.data.pipeline`; numpy only).

The epoch shuffle is a *random invertible BMMC* over sample indices — an
affine permutation of the dataset (paper §3 applied beyond the paper: a
PRP with O(1) state). Properties the framework relies on:

* **O(1) state**: (A, c, epoch) fully determines the order — a restored or
  replacement host recomputes its shard without coordination (straggler /
  fault-tolerance story, DESIGN.md §5).
* **Exactly invertible**: sample -> position and position -> sample are both
  O(n-bit matvec); auditing which samples a failed step consumed is exact.
* **Shard-local evaluation**: host h evaluates only positions
  [h*per_host, (h+1)*per_host) — no global shuffle buffer.

Token streams are synthesized deterministically per sample id (the
repository ships no corpus; swap ``sample_tokens`` for a real tokenizer-backed
reader in production).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Iterator, Optional

import numpy as np

from ..core.bmmc import Bmmc


@dataclasses.dataclass(frozen=True)
class DataConfig:
    n_samples_log2: int = 20          # dataset size = 2^n (paper's setting)
    seq_len: int = 128
    vocab_size: int = 256
    seed: int = 0


def epoch_bmmc(cfg: DataConfig, epoch: int) -> Bmmc:
    """The affine shuffle for one epoch (deterministic in (seed, epoch))."""
    rng = random.Random((cfg.seed << 20) ^ epoch)
    return Bmmc.random(cfg.n_samples_log2, rng)


def sample_tokens(cfg: DataConfig, sample_id: int) -> np.ndarray:
    """Synthetic *learnable* token stream for one sample id (deterministic).

    Tokens follow an affine successor rule t_{i+1} = (5 t_i + 17) mod V with
    10% noise — a model that learns the rule reaches ~0.1 * ln(V) loss, so
    training progress is observable (pure-random tokens would pin the loss
    at the ln(V) entropy floor).
    """
    rng = np.random.default_rng(np.uint64((cfg.seed << 32) ^ sample_id))
    v = cfg.vocab_size
    out = np.empty(cfg.seq_len + 1, dtype=np.int32)
    out[0] = rng.integers(0, v)
    noise = rng.random(cfg.seq_len) < 0.1
    rand = rng.integers(0, v, size=cfg.seq_len)
    for i in range(cfg.seq_len):
        out[i + 1] = rand[i] if noise[i] else (5 * out[i] + 17) % v
    return out


@dataclasses.dataclass
class ShardedLoader:
    """Batch iterator for one host shard; resumable from (epoch, step)."""

    cfg: DataConfig
    batch_size: int               # per-host batch
    host_id: int = 0
    n_hosts: int = 1
    epoch: int = 0
    step: int = 0                 # batches already consumed this epoch

    def __post_init__(self):
        total = 1 << self.cfg.n_samples_log2
        assert total % self.n_hosts == 0
        self.per_host = total // self.n_hosts

    def _shuffled_id(self, position: int) -> int:
        """Global position -> sample id through the epoch's BMMC."""
        b = epoch_bmmc(self.cfg, self.epoch)
        # permutation: sample x lands at position A x ^ c; reading order is
        # the inverse map.
        return b.inverse().apply(position)

    def state(self) -> Dict:
        return {"epoch": self.epoch, "step": self.step,
                "host_id": self.host_id, "seed": self.cfg.seed}

    def restore(self, state: Dict):
        assert state["seed"] == self.cfg.seed, "shuffle seed mismatch"
        self.epoch, self.step = state["epoch"], state["step"]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        start = self.host_id * self.per_host + self.step * self.batch_size
        if self.step * self.batch_size + self.batch_size > self.per_host:
            self.epoch += 1
            self.step = 0
            start = self.host_id * self.per_host
        toks = np.stack([
            sample_tokens(self.cfg, self._shuffled_id(start + i))
            for i in range(self.batch_size)])
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
