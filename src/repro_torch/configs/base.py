"""Model configuration schema + the assigned input-shape registry.

A copy of ``repro.configs.base`` (the port imports nothing of the JAX
package).  Every config of the JAX package is registered: the dense
``llama3.2-1b``, ``smollm-360m``, ``llama3-8b`` and ``glm4-9b``, the MoE ``granite-moe-3b-a800m``, the attention-free SSM
``mamba2-130m``, the hybrid ``hymba-1.5b`` (parallel attention and Mamba-2
heads), the VLM ``internvl2-1b`` (a stub patch-embedding prefix) and the
encoder-decoder ``whisper-medium`` (stub frame embeddings), and the
trillion-parameter MoE ``kimi-k2-1t-a32b``, which runs at full width only in
the dry-run (its reduced variant serves on a card).
``reduced()`` gives the same smoke variant as the JAX package, so the
parity tests load one set of weights into both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    expert_d_ff: int = 0  # per-expert FFN width (MoE archs)
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # --- audio (enc-dec) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500  # cross-attention KV length at decode
    decoder_seq: int = 448  # text positions in train batches
    # --- vlm ---
    num_patches: int = 0  # stub vision-prefix length
    # --- common ---
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 8192  # used only by the long-decode variant
    dtype: str = "bfloat16"
    remat: bool = True
    scan_unroll: int = 1  # full-unroll used by the cost-calibration pass
    source: str = ""  # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=d_model // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token
            else 0,
            expert_d_ff=min(self.expert_d_ff, 128) if self.expert_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=16 if self.encoder_layers else self.encoder_seq,
            decoder_seq=16 if self.encoder_layers else self.decoder_seq,
            num_patches=8 if self.num_patches else 0,
            sliding_window=64,
            # drop-free at smoke scale: cap(T) = 2T covers the max
            # per-expert load, so full-sequence forward == incremental
            # decode even with sub-128 (8-aligned) capacities
            capacity_factor=4.0,
            dtype="float32",
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    # importing the module registers its config
    from repro_torch.configs import (  # noqa: F401
        glm4_9b,
        granite_moe_3b_a800m,
        hymba_1_5b,
        internvl2_1b,
        kimi_k2_1t_a32b,
        llama3_2_1b,
        llama3_8b,
        mamba2_130m,
        smollm_360m,
        whisper_medium,
    )
