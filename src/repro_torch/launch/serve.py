"""Serving launcher: batched prefill+decode requests against any registered arch.

``python -m repro_torch.launch.serve --arch smollm-360m --requests 4 --new 16``
runs on the card (also ``llama3.2-1b``, ``llama3-8b``, ``glm4-9b``,
``granite-moe-3b-a800m``, ``mamba2-130m``, ``hymba-1.5b``, ``internvl2-1b``
or ``whisper-medium``); ``--device cpu`` runs the plain versions on the CPU.
As in ``repro.launch.serve``, an audio request carries 32 stub frame
embeddings (``--frames``; the config's ``encoder_seq`` is one 30 s window)
and a vlm request the config's ``num_patches`` stub patch embeddings
ahead of its prompt (``--patches``).
Weights are random, drawn from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

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
    inputs: Dict[str, torch.Tensor]  # what prefill reads besides the prompt: frames, patch_embeds

    @property
    def batch(self) -> Dict[str, torch.Tensor]:
        return {"tokens": self.prompts, **self.inputs}


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
    frames: int = 32,
    patches: Optional[int] = None,
) -> Server:
    """A server of ``arch`` and its requests (drawn from ``seed`` in the JAX launcher's order).

    ``frames``: stub frame embeddings per audio request; ``patches``: stub
    patch embeddings per vlm request (None: the config's ``num_patches``).
    """
    cfg = get_config(arch)
    if not full:
        cfg = cfg.reduced()
    api = build_model(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(seed), device)
    rng = np.random.default_rng(seed)

    def embeds(n):
        x = rng.standard_normal((requests, n, cfg.d_model), dtype=np.float32) * 0.02
        return torch.as_tensor(x, device=device)

    inputs = {"frames": embeds(frames)} if cfg.family == "audio" else {}
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(requests, prompt_len)), device=device
    )
    if cfg.family == "vlm":
        inputs["patch_embeds"] = embeds(cfg.num_patches if patches is None else patches)
    prefix = inputs["patch_embeds"].shape[1] if "patch_embeds" in inputs else 0
    engine = Engine(
        api,
        params,
        GenerationConfig(
            max_new_tokens=new, cache_len=prefix + prompt_len + new,
            sliding_window=sliding_window,
        ),
    )
    return Server(cfg, api, engine, prompts, inputs)


def timed_generate(server: Server) -> Tuple[Generation, float]:
    """One batched generation; wall seconds up to the last token on the host."""
    device = server.prompts.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = server.engine.generate(server.batch)
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
    ap.add_argument("--frames", type=int, default=32, help="stub frames per audio request")
    ap.add_argument("--patches", type=int, default=None,
                    help="stub patches per vlm request (default: the config's num_patches)")
    args = ap.parse_args(argv)

    server = build_server(
        args.arch,
        requests=args.requests,
        prompt_len=args.prompt_len,
        new=args.new,
        full=args.full,
        sliding_window=args.sliding_window,
        device=args.device,
        frames=args.frames,
        patches=args.patches,
    )
    out, dt = timed_generate(server)
    print(
        f"{server.cfg.name} on {device_name(args.device)}: generated {tuple(out.tokens.shape)} "
        f"in {dt:.3f}s ({args.requests * args.new / dt:.1f} tok/s, first call)"
    )
    print("sample:", out.tokens[0, :8].tolist())


if __name__ == "__main__":
    main()
