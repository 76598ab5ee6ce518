"""Synthetic token stream (the port's copy of the JAX package's generator).

A deterministic per-step mixture of a sparse Markov chain over the first
``min(vocab, 512)`` tokens and 5% noise tokens; numpy only, so the same
seed gives the same prompts in both packages (the JAX package's
``kind="markov"`` stream).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Deterministic synthetic LM stream."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self._k = min(cfg.vocab, 512)
        self._succ = rng.integers(0, self._k, size=(self._k, 4)).astype(
            np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1_000_003 + step)
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self._k, size=b)
        choices = rng.integers(0, 4, size=(b, s))
        noise = rng.random((b, s)) < 0.05
        noise_tok = rng.integers(0, self._k, size=(b, s))
        for t in range(s):
            nxt = self._succ[toks[:, t] % self._k, choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], noise_tok[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_dataset(cfg: DataConfig) -> SyntheticLM:
    return SyntheticLM(cfg)
