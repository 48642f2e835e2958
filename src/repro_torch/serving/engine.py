"""Serving engine: batched prefill + autoregressive decode, and scoring.

Torch twin of ``repro.serving.engine``.  Generation prefills into caches
``GenerationConfig.cache_len`` long and decodes from there; the batch
carries what the family's prefill reads besides the prompt (``frames``
for audio, ``patch_embeds`` for vlm).  Scoring is text only, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.models.model import ModelApi
from repro_torch.training.grpo import token_logprobs


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 => greedy
    cache_len: int = 512
    sliding_window: int = 0


class Generation(NamedTuple):
    tokens: torch.Tensor  # [B, max_new] int64
    logprobs: torch.Tensor  # [B, max_new] f32: log-prob of each chosen token
    logits: torch.Tensor  # [B, max_new, V] f32: the logits each token was drawn from


class Engine:
    """Batched generation and scoring.  ``rules``: the parameters are placed on the
    mesh (``ModelApi.init(..., rules=rules)``) and so are the requests; every rank
    of the mesh calls the engine with the same whole batch, and every rank gets
    the whole result (the logits gathered over the mesh at each step)."""

    def __init__(self, api: ModelApi, params, gen: GenerationConfig, rules=None):
        self.api = api
        self.params = params
        self.gen = gen
        self.rules = rules

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.rules is None else self.rules.full(t)

    @torch.inference_mode()
    def generate(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Generation:
        """Greedy (argmax, first maximum) or, with temperature > 0, sampled with ``generator``.

        A vlm prompt's patches come ahead of its tokens in the cache.
        """
        gen = self.gen
        S = batch["tokens"].shape[1]
        if self.api.cfg.family == "vlm" and "patch_embeds" in batch:
            S += batch["patch_embeds"].shape[1]
        if S + gen.max_new_tokens > gen.cache_len:
            raise ValueError(
                f"prompt {S} + {gen.max_new_tokens} new tokens exceed cache_len {gen.cache_len}"
            )
        logits, state = self.api.prefill(self.params, batch, cache_len=gen.cache_len,
                                         rules=self.rules)
        logits = self._whole(logits)
        if gen.temperature > 0 and generator is None:
            generator = torch.Generator(device=logits.device).manual_seed(0)
        toks, logps, step_logits = [], [], []
        for i in range(gen.max_new_tokens):
            if gen.temperature > 0:
                probs = torch.softmax(logits / gen.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            logp = torch.log_softmax(logits, dim=-1)
            logps.append(logp.gather(-1, tok[:, None])[:, 0])
            toks.append(tok)
            step_logits.append(logits)
            if i + 1 < gen.max_new_tokens:  # the last token needs no decode step
                logits, state = self.api.decode_step(
                    self.params, state, tok[:, None], sliding_window=gen.sliding_window,
                    rules=self.rules,
                )
                logits = self._whole(logits)
        return Generation(
            torch.stack(toks, dim=1), torch.stack(logps, dim=1), torch.stack(step_logits, dim=1)
        )

    @torch.inference_mode()
    def score(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Sequence log-likelihood [N] (used by LLM-as-judge reward services).

        Text only: a vlm's ``patch_embeds`` are not read, as in JAX; the
        audio family raises (``token_logprobs``).
        """
        logp = self._whole(token_logprobs(self.params, batch["tokens"], self.api, self.rules))
        mask = batch.get("mask")
        if mask is not None:
            return torch.sum(logp * mask, dim=-1)
        return torch.sum(logp, dim=-1)
