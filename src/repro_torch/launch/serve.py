"""Serving launcher: batched prefill+decode requests against a dense, MoE, SSM or hybrid arch.

``python -m repro_torch.launch.serve --arch smollm-360m --requests 4 --new 16``
runs on the card (also ``--arch llama3.2-1b``, ``granite-moe-3b-a800m``,
``mamba2-130m`` or ``hymba-1.5b``); ``--device cpu`` runs the plain versions
on the CPU.
Weights are random, drawn from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.models import ModelApi, build_model
from repro_torch.serving.engine import Engine, Generation, GenerationConfig


@dataclass
class Server:
    cfg: ModelConfig
    api: ModelApi
    engine: Engine
    prompts: torch.Tensor  # [requests, prompt_len] int64


def device_name(device: torch.device | str) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def build_server(
    arch: str,
    *,
    requests: int = 4,
    prompt_len: int = 32,
    new: int = 16,
    full: bool = False,
    sliding_window: int = 0,
    device: torch.device | str = "cuda",
    seed: int = 0,
) -> Server:
    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    api = build_model(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(seed), device)
    engine = Engine(
        api,
        params,
        GenerationConfig(
            max_new_tokens=new, cache_len=prompt_len + new, sliding_window=sliding_window
        ),
    )
    rng = np.random.default_rng(seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(requests, prompt_len)), device=device
    )
    return Server(cfg, api, engine, prompts)


def timed_generate(server: Server) -> Tuple[Generation, float]:
    """One batched generation; wall seconds up to the last token on the host."""
    device = server.prompts.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = server.engine.generate({"tokens": server.prompts})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--sliding-window", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    server = build_server(
        args.arch,
        requests=args.requests,
        prompt_len=args.prompt_len,
        new=args.new,
        full=args.full,
        sliding_window=args.sliding_window,
        device=args.device,
    )
    out, dt = timed_generate(server)
    print(
        f"{server.cfg.name} on {device_name(args.device)}: generated {tuple(out.tokens.shape)} "
        f"in {dt:.3f}s ({args.requests * args.new / dt:.1f} tok/s, first call)"
    )
    print("sample:", out.tokens[0, :8].tolist())


if __name__ == "__main__":
    main()
