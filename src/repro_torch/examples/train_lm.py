"""End-to-end driver: pre-train a ~100M-class llama-family model on the
synthetic Markov stream for a few hundred steps.

Torch twin of ``examples/train_lm.py``: the smollm-360m architecture at
width 512 (12 layers, 8 heads / 4 KV, head dim 64, d_ff 1536, f32; ~65M
parameters with the tied 49k vocab), AdamW at lr 6e-4 after 20 warm-up
steps, on a stream over the first 2,048 token ids.  The loss must fall
from ~ln(V) toward the stream's entropy floor ln(branching).  It runs
through ``launch/train.py`` (``trainer_from_config`` and ``train``) and
writes the parameters with ``training/checkpoint.py`` when ``--ckpt``
names a file.

Run: PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
(on the card; ``--device cpu`` for the CPU, ``--reduced`` for the
config's two-layer smoke variant).
"""

import argparse
import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.launch.train import train, trainer_from_config
from repro_torch.training import AdamWConfig, save_checkpoint


def model_config(reduced: bool = False):
    cfg = dataclasses.replace(
        get_config("smollm-360m"),
        num_layers=12,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        head_dim=64,
        d_ff=1536,
        dtype="float32",
        name="smollm-100m-class",
    )
    return cfg.reduced() if reduced else cfg


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=None, help="write the trained parameters here (.npz)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="the two-layer smoke variant")
    args = ap.parse_args(argv)

    cfg = model_config(args.reduced)
    trainer = trainer_from_config(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq, device=args.device,
        opt=AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps),
        active_vocab=min(2048, cfg.vocab_size),
    )
    floor = trainer.stream.entropy_floor()
    print(f"model: {cfg.name}  params={trainer.api.param_count() / 1e6:.1f}M  on {args.device}")
    metrics = train(trainer, args.steps)
    last = metrics[-1]
    print(f"final loss {last['loss']:.3f} (first {metrics[0]['loss']:.3f}, floor {floor:.3f})  "
          f"lr {last['lr']:.2e}  gnorm {last['grad_norm']:.2f}", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, trainer.state.params, step=args.steps)
        print(f"saved {args.ckpt}")
    return metrics


if __name__ == "__main__":
    main()
