"""Train steps: LM pre-training, plain and with gradient accumulation.

Torch twin of ``repro.training.train_step``.  Gradients come from
autograd (through the kernels' backward on the card) and the update is
``optimizer.adamw_update``, in place.  Metrics are detached device
scalars: reading one waits for the step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.models.layers import ParamTree
from repro_torch.models.model import ModelApi
from repro_torch.sharding.rules import is_dtensor
from repro_torch.training.optimizer import (
    AdamWConfig,
    AdamWState,
    adamw_update,
    init_adamw,
    named_params,
)


@dataclass
class TrainState:
    params: ParamTree  # trainable; updated in place by each step
    opt: AdamWState


def init_train_state(
    api: ModelApi, generator: torch.Generator, device: torch.device | str = "cuda", rules=None
) -> TrainState:
    params = api.init(generator, device, trainable=True, rules=rules)
    return TrainState(params, init_adamw(params))


def grads_of(loss: torch.Tensor, params) -> Dict[str, torch.Tensor]:
    """d loss / d every parameter, keyed like ``named_params`` (zeros where unused).

    A parameter placed on a mesh gets its gradient with its own placements."""
    named = named_params(params)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    out = {}
    for (k, p), g in zip(named.items(), grads):
        if g is None:
            g = torch.zeros_like(p)
        elif is_dtensor(p) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        out[k] = g
    return out


def plain_metrics(metrics) -> Dict[str, torch.Tensor]:
    """Detached metrics, each a plain tensor (a DTensor's whole value) equal on every rank."""
    return {k: (v.full_tensor() if is_dtensor(v) else v).detach() for k, v in metrics.items()}


def apply_gradients(state: TrainState, loss: torch.Tensor, opt_cfg: AdamWConfig, metrics):
    """Differentiate ``loss``, take one AdamW step; -> (state, detached metrics)."""
    grads = grads_of(loss, state.params)
    _, opt, opt_metrics = adamw_update(opt_cfg, state.params, grads, state.opt)
    return TrainState(state.params, opt), plain_metrics({**metrics, **opt_metrics})


def make_train_step(api: ModelApi, opt_cfg: AdamWConfig, rules=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``rules``: the state's parameters and moments are placed on the mesh
    (``init_train_state(..., rules=rules)``), every rank calls the step with
    the same whole batch, and the metrics are plain scalars equal on every rank.
    """

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        loss, metrics = api.loss_fn(state.params, batch, rules)
        return apply_gradients(state, loss, opt_cfg, {"loss": loss, **metrics})

    return train_step


def make_grad_accum_train_step(api: ModelApi, opt_cfg: AdamWConfig, accum_steps: int, rules=None):
    """Microbatched step: batch leading dim = [accum, micro_batch, ...].

    Each micro-batch's gradients are summed in f32 in the parameters' own layout
    (a parameter on a mesh: a DTensor of its placements).  ``rules``: as
    ``make_train_step``'s."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        named = named_params(state.params)
        gsum = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in named.items()}
        lsum = torch.zeros((), dtype=torch.float32, device=next(iter(named.values())).device)
        for i in range(accum_steps):
            loss, _ = api.loss_fn(state.params, {k: v[i] for k, v in batch.items()}, rules)
            for k, g in grads_of(loss, state.params).items():
                gsum[k] += g
            lsum = lsum + loss.detach()
        grads = {k: g / accum_steps for k, g in gsum.items()}
        _, opt, opt_metrics = adamw_update(opt_cfg, state.params, grads, state.opt)
        return TrainState(state.params, opt), plain_metrics({"loss": lsum / accum_steps, **opt_metrics})

    return train_step
