"""GRPO pieces of the port.  So far only what scoring needs: ``token_logprobs``."""

from __future__ import annotations

import torch

from repro_torch.models.layers import logits_fn
from repro_torch.models.model import ModelApi
from repro_torch.models.transformer import arange_positions, embed_tokens, forward


def token_logprobs(params, tokens: torch.Tensor, api: ModelApi) -> torch.Tensor:
    """Log-prob of each realized next token; [N, S-1] f32."""
    cfg = api.cfg
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    h = forward(params, x, arange_positions(B, S, tokens.device), cfg)
    logits = logits_fn(params, h[:, :-1, :], cfg)  # [N, S-1, V] f32
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
