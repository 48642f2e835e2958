"""Unified model API: ``build_model(cfg)`` -> :class:`ModelApi`.

The port's façade over the dense, moe, ssm and hybrid families; serving,
scoring and training go through it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import ParamDef, ParamTree, init_from_schema, torch_dtype


def _leaves(node) -> Iterator[ParamDef]:
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    schema: Dict[str, Any]

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg)

    # ---- params ----------------------------------------------------------
    def init(
        self,
        generator: torch.Generator,
        device: torch.device | str = "cuda",
        trainable: bool = False,
    ) -> ParamTree:
        """Random parameters; frozen for serving unless ``trainable``."""
        return init_from_schema(self.schema, self.dtype, generator, device, trainable)

    def param_count(self) -> int:
        return sum(math.prod(p.shape) for p in _leaves(self.schema))

    # ---- training --------------------------------------------------------
    def loss_fn(self, params, batch: Dict[str, torch.Tensor]):
        """(loss, metrics) of ``transformer.lm_loss``; the vlm and audio families raise."""
        if self.cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"{self.cfg.name}: {self.cfg.family} training is not ported yet (ROADMAP A8)"
            )
        return transformer.lm_loss(params, batch, self.cfg)

    # ---- serving ---------------------------------------------------------
    def prefill(self, params, batch, cache_len: Optional[int] = None):
        return transformer.prefill(params, batch, self.cfg, cache_len)

    def decode_step(self, params, state, token, sliding_window: int = 0):
        return transformer.decode_step(params, state, token, self.cfg, sliding_window)

    def init_decode_state(self, batch: int, cache_len: int, device: torch.device | str = "cuda"):
        return transformer.init_decode_state(self.cfg, batch, cache_len, self.dtype, device)


def build_model(cfg: ModelConfig) -> ModelApi:
    """Dense, moe, ssm and hybrid families; vlm and audio raise NotImplementedError."""
    return ModelApi(cfg=cfg, schema=transformer.model_schema(cfg))
