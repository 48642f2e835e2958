"""GRPO (Group Relative Policy Optimization, Shao et al. 2024).

Torch twin of ``repro.training.grpo``.  For each prompt a group of G
trajectories is rolled out; advantages are the group-normalised rewards;
the policy gradient uses a PPO-style clipped ratio against the
rollout-time log-probs, plus a k3 KL penalty to the reference policy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.layers import logits_fn, sharded_token_logprobs
from repro_torch.models.model import ModelApi
from repro_torch.models.transformer import arange_positions, embed_tokens, forward
from repro_torch.sharding.rules import is_dtensor
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import TrainState, apply_gradients


def group_advantages(rewards: torch.Tensor) -> torch.Tensor:
    """rewards [B, G] -> group-normalised advantages [B, G] (population std, as jnp.std)."""
    mean = rewards.mean(dim=1, keepdim=True)
    std = rewards.std(dim=1, keepdim=True, correction=0)
    return (rewards - mean) / (std + 1e-6)


def token_logprobs(params, tokens: torch.Tensor, api: ModelApi, rules=None) -> torch.Tensor:
    """Log-prob of each realized next token; [N, S-1] f32.

    Through the decoder-only forward, as in JAX (a vlm scores its text
    alone).  An encoder-decoder has no such forward, and the JAX function
    cannot score one either (it reads ``params["layers"]``, which the
    encoder-decoder schema lacks): the audio family raises.  Live ``rules``:
    the tokens are placed on the mesh, each model rank keeps its vocabulary
    rows' logits (``sharded_token_logprobs``: nothing is gathered, and the
    result carries a gradient) and the result is a DTensor laid out as the
    tokens.
    """
    cfg = api.cfg
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: an encoder-decoder (audio) has no decoder-only forward to score "
            "tokens with; the JAX package cannot score it either"
        )
    B, S = tokens.shape
    if rules is not None and rules.live:
        tokens = rules.distribute(tokens, ("batch", None))
    x = embed_tokens(params, tokens, cfg, rules)
    h, _ = forward(params, x, arange_positions(B, S, tokens.device), cfg, rules=rules)
    if is_dtensor(h):
        return sharded_token_logprobs(params, h[:, :-1, :], tokens[:, 1:], cfg, rules)
    logits = logits_fn(params, h[:, :-1, :], cfg)  # [N, S-1, V] f32
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, tokens[:, 1:, None].long())[..., 0]


def grpo_loss(
    params,
    batch: Dict[str, torch.Tensor],
    api: ModelApi,
    rules=None,
    clip_eps: float = 0.2,
    kl_coef: float = 0.02,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens [N,S], mask [N,S-1] (1 on generated positions),
    advantages [N], old_logp [N,S-1], ref_logp [N,S-1].

    Live ``rules``: the batch is placed on the mesh as the tokens, each rank
    works on its block of rows, and the masked sums are summed over the data
    axes: the loss and the metrics are plain scalars, equal on every rank.
    """
    tokens = batch["tokens"]
    logp = token_logprobs(params, tokens, api, rules)
    ds = False
    if is_dtensor(logp):
        ds = rules.batch_sharded(logp)
        logp = logp.to_local()
        batch = {k: rules.distribute(v, ("batch",) + (None,) * (v.dim() - 1)).to_local()
                 for k, v in batch.items()}

    def total(t):
        return rules.sum_data(torch.sum(t), ds) if ds else torch.sum(t)

    mask = batch["mask"].to(torch.float32)
    adv = batch["advantages"][:, None]  # [N,1] broadcast over positions
    ratio = torch.exp(logp - batch["old_logp"])
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    pg = -torch.minimum(unclipped, clipped)
    # k3 KL estimator (non-negative): exp(d) - d - 1
    d = batch["ref_logp"] - logp
    kl = torch.exp(d) - d - 1.0
    denom = torch.clamp(total(mask), min=1.0)
    pg_loss = total(pg * mask) / denom
    kl_loss = total(kl * mask) / denom
    loss = pg_loss + kl_coef * kl_loss
    return loss, {
        "pg_loss": pg_loss,
        "kl": kl_loss,
        "ratio_mean": total(ratio * mask) / denom,
    }


def make_grpo_step(api: ModelApi, opt_cfg: AdamWConfig, rules=None):
    """Returns ``step(state, batch) -> (state, metrics)``; the parameters are updated in place.

    ``rules``: as ``make_train_step``'s (every rank calls the step with the same whole
    batch; the metrics are plain scalars equal on every rank)."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, metrics = grpo_loss(state.params, batch, api, rules)
        return apply_gradients(state, loss, opt_cfg, {"loss": loss, **metrics})

    return step
