"""Token streams (the port's copy of the JAX package's pipeline).

``kind="markov"`` (the default): a deterministic per-step mixture of a
sparse Markov chain over the first ``min(vocab, 512)`` tokens and 5%
noise tokens. ``kind="uniform"``: tokens drawn uniformly over the whole
vocabulary. Both are numpy only, so the same seed gives the same batches
in both packages. With ``enc_ctx`` set, a batch of either also holds the
stub frontend's embeddings ``enc_embeds`` (B, enc_ctx, d_model), drawn
from the same generator after the tokens, as JAX's are.

``kind="file"`` (:class:`FileTokens`): windows of ``seq_len + 1`` tokens
cut from a memory-mapped uint16 token file at seeded starts, each token
taken modulo ``vocab``. As in the JAX package, such a batch holds no
``enc_embeds``, so it cannot feed an encoder-decoder or a cross-attention
model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

KINDS = ("markov", "uniform", "file")


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    kind: str = "markov"            # markov | uniform | file
    path: Optional[str] = None      # the token file of kind "file"
    seed: int = 0
    enc_ctx: Optional[int] = None   # audio/vision stub frames per sample
    d_model: Optional[int] = None


class SyntheticLM:
    """Deterministic synthetic LM stream (kinds ``markov`` and
    ``uniform``)."""

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
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab, size=(b, s + 1),
                                dtype=np.int32)
        else:
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


class FileTokens:
    """A memory-mapped token file -> (batch, seq) windows: row ``i`` of
    step ``step`` starts at a position drawn from ``default_rng(seed *
    7_777_777 + step)``, its tokens modulo ``vocab``."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        if not cfg.path:
            raise ValueError("a file stream needs DataConfig.path")
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        n = len(self.data) - (s + 1)
        rng = np.random.default_rng(cfg.seed * 7_777_777 + step)
        starts = rng.integers(0, n, size=b)
        toks = np.stack([np.asarray(self.data[i:i + s + 1])
                         for i in starts]).astype(np.int32)
        toks %= cfg.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_dataset(cfg: DataConfig):
    """The stream of ``cfg.kind``: :class:`FileTokens` for ``file``, else
    :class:`SyntheticLM`."""
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown data kind {cfg.kind!r}: one of {KINDS}")
    if cfg.kind == "file":
        return FileTokens(cfg)
    return SyntheticLM(cfg)
