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
    @property
    def _family(self):
        """The module that holds this family's functions."""
        return encdec if self.cfg.family == "audio" else transformer

    def loss_fn(self, params, batch: Dict[str, torch.Tensor]):
        """(loss, metrics): ``transformer.lm_loss`` (vlm: after ``patch_embeds``), or
        ``encdec.lm_loss`` over ``frames`` and ``tokens`` for audio."""
        return self._family.lm_loss(params, batch, self.cfg)

    # ---- serving ---------------------------------------------------------
    def prefill(self, params, batch, cache_len: Optional[int] = None):
        return self._family.prefill(params, batch, self.cfg, cache_len)

    def decode_step(self, params, state, token, sliding_window: int = 0):
        return self._family.decode_step(params, state, token, self.cfg, sliding_window)

    def init_decode_state(self, batch: int, cache_len: int, device: torch.device | str = "cuda"):
        return self._family.init_decode_state(self.cfg, batch, cache_len, self.dtype, device)


def model_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter schema of any family: the encoder-decoder's for audio."""
    return (encdec if cfg.family == "audio" else transformer).model_schema(cfg)


def build_model(cfg: ModelConfig) -> ModelApi:
    return ModelApi(cfg=cfg, schema=model_schema(cfg))
