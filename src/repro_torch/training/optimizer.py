"""AdamW, ported literally from ``repro.training.optimizer``.

Not ``torch.optim.AdamW``, which differs in several places: the update
clips by the global norm of every gradient (f32), takes the learning rate
at ``step + 1`` from a linear warmup and cosine decay, keeps f32 moments,
puts the decoupled decay inside ``delta`` and computes the step in f32
before casting back to each parameter's dtype.  The parameters are
updated in place (``copy_`` under ``no_grad``), so every holder of the
tree (cached layer views, a serving engine) sees the new weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32
    m: Dict[str, torch.Tensor]  # f32, keyed like named_params
    v: Dict[str, torch.Tensor]  # f32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named_params(params: Params) -> Dict[str, torch.Tensor]:
    """The tensors of a ParamTree (``a.b.c`` names) or of a name -> tensor mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_adamw(params: Params) -> AdamWState:
    """Zero f32 moments laid out as the parameters (a parameter placed on a mesh gets
    moments with its placements, as ``adamw_state_specs`` gives them)."""
    named = named_params(params)
    device = next(iter(named.values())).device

    def zeros():
        return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in named.items()}

    return AdamWState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())


def flat_named(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested mapping's leaves keyed ``a.b.c``, as ``named_params`` keys a ParamTree."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flat_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def abstract_adamw(params: Mapping[str, Any]) -> AdamWState:
    """``init_adamw``'s tensors on the ``meta`` device, of nested abstract parameters."""
    zeros = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
             for k, p in flat_named(params).items()}
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"), zeros, dict(zeros))


def adamw_state_specs(param_specs: Mapping[str, Any]) -> AdamWState:
    """Optimizer-state specs from parameter specs: the moments take the parameters'."""
    flat = flat_named(param_specs)
    return AdamWState((), flat, dict(flat))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``; f32 scalar."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(g.to(torch.float32).square().sum() for g in grads))


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: Params,
    grads: Mapping[str, torch.Tensor],
    state: AdamWState,
) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping and decoupled decay.

    ``grads`` is keyed like ``named_params(params)``.  Returns
    (params, updated in place; the new state; {"grad_norm", "lr"}).
    """
    named = named_params(params)
    if grads.keys() != named.keys():
        raise KeyError(f"grads and params differ: {sorted(set(grads) ^ set(named))}")
    gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    new_m, new_v = {}, {}
    for name, p in named.items():
        g = grads[name].to(torch.float32) * scale
        m = b1 * state.m[name] + (1 - b1) * g
        v = b2 * state.v[name] + (1 - b2) * g.square()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_m[name], new_v[name] = m, v
    return params, AdamWState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}
