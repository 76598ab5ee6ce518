"""Synthetic token stream (the port's copy of the JAX package's generator).

A deterministic per-step mixture of a sparse Markov chain over the first
``min(vocab, 512)`` tokens and 5% noise tokens; numpy only, so the same
seed gives the same prompts in both packages (the JAX package's
``kind="markov"`` stream). With ``enc_ctx`` set, a batch also holds
the stub frontend's embeddings ``enc_embeds`` (B, enc_ctx, d_model),
drawn from the same generator after the tokens, as JAX's are.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    enc_ctx: Optional[int] = None   # audio/vision stub frames per sample
    d_model: Optional[int] = None


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
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.enc_ctx:
            out["enc_embeds"] = rng.standard_normal(
                (b, cfg.enc_ctx, cfg.d_model)).astype(np.float32) * 0.02
        return out


def make_dataset(cfg: DataConfig) -> SyntheticLM:
    return SyntheticLM(cfg)
