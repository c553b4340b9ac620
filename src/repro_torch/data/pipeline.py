"""Deterministic data pipeline (the JAX package's ``data/pipeline.py``,
its numpy code copied).

Every batch is a pure function of (seed, step) — after a failure the
restored step index replays the exact same batches, which is what makes
checkpoint/restart bitwise-reproducible.  Two sources:

* ``SyntheticLM``   — deterministic zipf-ish token stream (tests, the
  card's smoke run);
* ``FileDataset``   — memory-mapped token file with per-step strided reads.

Batches come out as numpy, array for array the JAX package's;
:func:`to_device` moves one onto a torch device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    frontend: str = "none"     # none | patch_embeds | frame_embeds
    n_prefix: int = 0
    d_model: int = 0


class SyntheticLM:
    """Zipf-distributed tokens; labels = next-token shift."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        if cfg.frontend == "patch_embeds":
            s_text = S - cfg.n_prefix
            toks = self._tokens(rng, B, s_text + 1)
            return {
                "patch_embeds": rng.standard_normal(
                    (B, cfg.n_prefix, cfg.d_model)).astype(np.float32),
                "tokens": toks[:, :-1],
                "labels": toks[:, 1:],
            }
        if cfg.frontend == "frame_embeds":
            toks = self._tokens(rng, B, S + 1)
            return {
                "frame_embeds": rng.standard_normal(
                    (B, S, cfg.d_model)).astype(np.float32),
                "labels": toks[:, 1:],
            }
        toks = self._tokens(rng, B, S + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _tokens(self, rng, B, S):
        z = rng.zipf(1.3, size=(B, S)).astype(np.int64)
        return np.clip(z - 1, 0, self.cfg.vocab - 1).astype(np.int32)

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class FileDataset:
    """Flat binary token file (int32), strided deterministic batches."""

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.tokens) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        idx = rng.integers(0, self.n_windows, size=cfg.global_batch)
        starts = idx * cfg.seq_len
        rows = np.stack([self.tokens[s:s + cfg.seq_len + 1] for s in starts])
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}


def make_dataset(cfg: DataConfig, path: Optional[str] = None):
    return FileDataset(path, cfg) if path else SyntheticLM(cfg)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as torch tensors on ``device``, dtypes kept (int32
    tokens and labels, f32 embeddings)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
