"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Torch twin of ``repro.launch.train``, with the same flags plus
``--device`` (default ``cuda``), ``--frames`` and ``--patches``: it trains
the reduced variant of any registered architecture on the synthetic
Markov stream (``--full`` for the published widths), on the card's kernels
and their backward kernels, or on the CPU's plain versions with
``--device cpu``.  As in JAX, an audio batch adds 32 stub frame embeddings
a sequence (``--frames``) and a vlm batch the config's ``num_patches``
stub patch embeddings (``--patches``), each drawn anew every step.
Departure: the audio text is ``--seq`` tokens long (JAX cuts it to 16;
``--seq 16`` gives its batch shape).
Weights are random, drawn from a seeded ``torch.Generator``.
``trainer_from_config`` builds the same trainer for a ``ModelConfig`` given
as is.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.models import ModelApi, build_model
from repro_torch.training import (
    AdamWConfig,
    DataConfig,
    MarkovTextStream,
    TrainState,
    init_train_state,
    make_train_step,
    save_checkpoint,
)


@dataclass
class Trainer:
    cfg: ModelConfig
    api: ModelApi
    state: TrainState
    step: Callable  # (state, batch) -> (state, metrics)
    stream: MarkovTextStream
    seq: int
    device: torch.device
    frames: int  # stub frame embeddings a sequence (audio)
    patches: int  # stub patch embeddings a sequence (vlm)
    rng: np.random.Generator  # draws the stub embeddings


def build_trainer(
    arch: str,
    *,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    full: bool = False,
    device: torch.device | str = "cuda",
    seed: int = 0,
    frames: int = 32,
    patches: Optional[int] = None,
) -> Trainer:
    cfg = get_config(arch)
    return trainer_from_config(cfg if full else cfg.reduced(), steps=steps, batch=batch, seq=seq,
                               device=device, seed=seed, frames=frames, patches=patches)


def trainer_from_config(
    cfg: ModelConfig,
    *,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    device: torch.device | str = "cuda",
    seed: int = 0,
    frames: int = 32,
    patches: Optional[int] = None,
    opt: Optional[AdamWConfig] = None,
    active_vocab: Optional[int] = None,
) -> Trainer:
    """``opt``: None for the launcher's AdamW (lr 1e-3, 10 warm-up steps);
    ``active_vocab``: the stream's token ids (None: the whole vocabulary)."""
    api = build_model(cfg)
    device = torch.device(device)
    state = init_train_state(api, torch.Generator(device=device).manual_seed(seed), device)
    opt = opt or AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    stream = MarkovTextStream(DataConfig(cfg.vocab_size, seq, batch, seed=seed,
                                         active_vocab=active_vocab))
    return Trainer(cfg, api, state, make_train_step(api, opt), stream, seq, device, frames,
                   cfg.num_patches if patches is None else patches, np.random.default_rng(seed))


def next_batch(trainer: Trainer) -> Dict[str, torch.Tensor]:
    """The stream's next tokens, with the family's stub embeddings (audio frames, vlm patches)."""
    raw = next(trainer.stream)
    out = {"tokens": torch.as_tensor(raw["tokens"][:, : trainer.seq], device=trainer.device)}
    cfg, B = trainer.cfg, out["tokens"].shape[0]
    n = {"audio": trainer.frames, "vlm": trainer.patches}.get(cfg.family)
    if n is not None:
        x = trainer.rng.standard_normal((B, n, cfg.d_model), dtype=np.float32) * 0.02
        out["frames" if cfg.family == "audio" else "patch_embeds"] = torch.as_tensor(
            x, device=trainer.device)
    return out


def train(trainer: Trainer, steps: int, log: Callable[[str], None] = print) -> List[Dict[str, float]]:
    """``steps`` steps on the stream; every step's metrics as floats (read after the last step)."""
    t0 = time.perf_counter()
    metrics = []
    for i in range(steps):
        trainer.state, m = trainer.step(trainer.state, next_batch(trainer))
        metrics.append(m)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:4d} loss {float(m['loss']):.3f} ({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
    return [{k: float(v) for k, v in m.items()} for m in metrics]


def main(argv: Optional[Sequence[str]] = None) -> Tuple[Trainer, List[Dict[str, float]]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=32, help="stub frames a sequence (audio)")
    ap.add_argument("--patches", type=int, default=None,
                    help="stub patches a sequence (vlm; default: the config's num_patches)")
    args = ap.parse_args(argv)

    trainer = build_trainer(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                            full=args.full, device=args.device, frames=args.frames,
                            patches=args.patches)
    print(f"{trainer.cfg.name}: {trainer.api.param_count() / 1e6:.1f}M params "
          f"({trainer.cfg.family}) on {args.device}")
    metrics = train(trainer, args.steps)
    if args.ckpt:
        save_checkpoint(args.ckpt, trainer.state.params, step=args.steps)
        print(f"saved {args.ckpt}")
    return trainer, metrics


if __name__ == "__main__":
    main()
