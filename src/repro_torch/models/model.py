"""Unified model API: ``build_model(cfg)`` -> :class:`ModelApi`.

The port's façade over the six families: the decoder-only dense, moe,
ssm, hybrid and vlm (``models.transformer``) and the audio
encoder-decoder (``models.encdec``); serving, scoring and training go
through it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import (
    ParamDef,
    ParamTree,
    abstract_from_schema,
    init_from_schema,
    specs_from_schema,
    torch_dtype,
)


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
        rules=None,
    ) -> ParamTree:
        """Random parameters; frozen for serving unless ``trainable``.  With live ``rules``
        each rank keeps its block of every leaf (``param_specs``): the same values as
        without them, drawn leaf by leaf."""
        return init_from_schema(self.schema, self.dtype, generator, device, trainable, rules)

    def abstract_params(self) -> Dict[str, Any]:
        """Tensors on the ``meta`` device in the schema's shape (the dry-run's stand-ins)."""
        return abstract_from_schema(self.schema, self.dtype)

    def param_specs(self, rules) -> Dict[str, Any]:
        return specs_from_schema(self.schema, rules)

    def param_count(self) -> int:
        return sum(math.prod(p.shape) for p in _leaves(self.schema))

    def active_param_count(self) -> int:
        """6*N*D roofline uses *active* params for MoE (top-k of experts)."""
        cfg = self.cfg
        total = self.param_count()
        if cfg.family != "moe" or not cfg.num_experts:
            return total
        per_expert = 3 * cfg.d_model * cfg.expert_d_ff * cfg.num_layers
        return total - per_expert * (cfg.num_experts - cfg.experts_per_token)

    # ---- training --------------------------------------------------------
    @property
    def _family(self):
        """The module that holds this family's functions."""
        return encdec if self.cfg.family == "audio" else transformer

    def loss_fn(self, params, batch: Dict[str, torch.Tensor], rules=None):
        """(loss, metrics): ``transformer.lm_loss`` (vlm: after ``patch_embeds``), or
        ``encdec.lm_loss`` over ``frames`` and ``tokens`` for audio."""
        return self._family.lm_loss(params, batch, self.cfg, rules)

    # ---- serving ---------------------------------------------------------
    def prefill(self, params, batch, cache_len: Optional[int] = None, rules=None):
        return self._family.prefill(params, batch, self.cfg, cache_len, rules)

    def decode_step(self, params, state, token, sliding_window: int = 0, rules=None):
        return self._family.decode_step(params, state, token, self.cfg, sliding_window, rules)

    def init_decode_state(self, batch: int, cache_len: int, device: torch.device | str = "cuda",
                          rules=None):
        family = self._family
        if family is encdec:
            return encdec.init_decode_state(self.cfg, batch, cache_len, self.dtype, device,
                                            rules=rules)
        return transformer.init_decode_state(self.cfg, batch, cache_len, self.dtype, device, rules)

    def abstract_decode_state(self, batch: int, cache_len: int):
        """The decode state's tensors on the ``meta`` device."""
        return self.init_decode_state(batch, cache_len, device="meta")

    def decode_state_specs(self, rules, batch: int, cache_len: int):
        return self._family.decode_state_specs(self.cfg, rules, batch, cache_len)


def model_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter schema of any family: the encoder-decoder's for audio."""
    return (encdec if cfg.family == "audio" else transformer).model_schema(cfg)


def build_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg=cfg, schema=model_schema(cfg))
