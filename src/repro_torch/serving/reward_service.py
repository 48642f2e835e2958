"""Reward services: real models deployed behind the GPU manager.

Torch twin of ``repro.serving.reward_service``.  The paper's MOPD workload
serves many teacher models whose SM activity averages <3% (§2.2 Fig. 3b) —
the motivating waste.  Here each service is an
:class:`~repro_torch.serving.engine.Engine` over a model; the GPU manager's
EOE decides which service is resident on which chunk, and the profiled DoP
scaling supplies the action's elasticity table.

Unlike the reference, which seeds a judge from ``hash(name)`` (salted per
process), a service's weights come from an explicit seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.action import TableElasticity
from repro_torch.core.managers.gpu import ServiceSpec
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine, GenerationConfig


@dataclasses.dataclass
class RewardService:
    """A deployable scoring service (LLM-as-judge / teacher log-prob)."""

    name: str
    cfg: ModelConfig
    engine: Engine
    state_gb: float

    def score(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.engine.score({"tokens": tokens})

    def spec(self) -> ServiceSpec:
        return ServiceSpec(self.name, self.state_gb, dops=(1, 2, 4, 8))

    # -- profiled elasticity (paper §4.1: profiled in advance) --------------
    @staticmethod
    def profiled_elasticity() -> TableElasticity:
        """TP scaling efficiency measured on teacher-model inference."""
        return TableElasticity(table=((1, 1.0), (2, 0.92), (4, 0.81), (8, 0.62)))


def deploy_reward_service(
    name: str, cfg: ModelConfig, seed: int, device: Optional[torch.device | str] = None
) -> RewardService:
    """Random weights drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    device = torch.device("cuda" if device is None else device)
    api = build_model(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(seed), device)
    engine = Engine(api, params, GenerationConfig(max_new_tokens=8, cache_len=128))
    state_gb = api.param_count() * 2 / 1e9  # bf16 weights
    return RewardService(name=name, cfg=cfg, engine=engine, state_gb=max(0.5, state_gb))
