"""Deterministic synthetic data pipeline (a NumPy-only copy of ``repro.training.data``).

No corpus is read.  The stream is a seeded sparse
Markov chain over the vocabulary with local n-gram structure, so models
*can* learn it (loss drops well below ln(V)) and runs are reproducible.
Batches are produced as numpy; the caller moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.transformer import DECODER_FAMILIES


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 4  # successors per state -> entropy ~= ln(branching)
    # tokens are drawn from the first ``active_vocab`` ids (None = all):
    # keeps the transition table memorizable at example scale while the
    # model's embedding/unembedding still span the full vocab
    active_vocab: int | None = None


class MarkovTextStream:
    """Infinite iterator of {tokens: [B, S+1]} next-token batches."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V, K = cfg.active_vocab or cfg.vocab_size, cfg.branching
        self._active = V
        # sparse transition table: each token has K allowed successors
        self._succ = rng.integers(0, V, size=(V, K), dtype=np.int64)
        self._rng = np.random.default_rng(cfg.seed + 1)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, S, K = cfg.batch_size, cfg.seq_len, cfg.branching
        V = self._active
        toks = np.empty((B, S + 1), dtype=np.int32)
        toks[:, 0] = self._rng.integers(0, V, size=B)
        choices = self._rng.integers(0, K, size=(B, S))
        for t in range(S):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"tokens": toks}

    def entropy_floor(self) -> float:
        """Best achievable mean NLL (uniform over K successors)."""
        return float(np.log(self.cfg.branching))


def batch_for(cfg_model, shape, seed: int = 0) -> Dict[str, np.ndarray]:
    """One concrete (non-abstract) batch matching an assigned InputShape.

    audio: ``shape.seq_len`` stub frames and ``decoder_seq`` tokens; vlm:
    ``num_patches`` stub patch embeddings and ``seq_len - num_patches``
    tokens; every other family ``seq_len`` tokens.  Departure from JAX: a
    family that no model of the port builds is refused, where JAX hands it
    tokens.
    """
    if cfg_model.family not in (*DECODER_FAMILIES, "audio"):
        raise ValueError(f"batch_for: no model of the port has family {cfg_model.family!r}")
    rng = np.random.default_rng(seed)
    B, S = shape.global_batch, shape.seq_len
    if cfg_model.family == "audio":
        return {
            "frames": rng.standard_normal((B, S, cfg_model.d_model)).astype(np.float32)
            * 0.02,
            "tokens": rng.integers(
                0, cfg_model.vocab_size, size=(B, cfg_model.decoder_seq)
            ).astype(np.int32),
        }
    if cfg_model.family == "vlm":
        P = cfg_model.num_patches
        return {
            "tokens": rng.integers(0, cfg_model.vocab_size, size=(B, S - P)).astype(
                np.int32
            ),
            "patch_embeds": rng.standard_normal((B, P, cfg_model.d_model)).astype(
                np.float32
            )
            * 0.02,
        }
    return {
        "tokens": rng.integers(0, cfg_model.vocab_size, size=(B, S)).astype(np.int32)
    }
