#!/usr/bin/env python3
"""Probes of the multi-device layer: gloo ranks that share one card (or the CPU).

    python3 tools/torch_mesh_probe.py drops [--device cpu]
    python3 tools/torch_mesh_probe.py bf16 [--seeds 21,22,...] [--device cpu]

``drops``: the train step of ``chip_smoke.py`` phase 10's reduced granite
(10 experts, top-2, 4 x 64 tokens, seed 24) on its (data 2, model 3) mesh,
once at the reduced config's capacity factor 4.0 and once at E / K = 5,
which drops nothing.  For each MoE layer it prints each data shard's
largest expert load, its capacity and the assignments it drops, as the
ranks' dispatch counts them, and the same over the unsharded run's own
routing at the data shards' capacity and at the global one; then the loss
and the largest gradient error of each leaf, sharded against unsharded,
relative to the leaf's largest magnitude.

``bf16``: phase 10's bf16 generations (granite at 8 layers, llama3.2-1b;
full width, 4 x (128 + 9)) on the mesh for each seed, held as phase 10
holds them (``chip_smoke.mesh_serve_errors``): each row's logit error
against the unsharded run until its tokens part, the errors of both runs
against an f32 forward of the same weights teacher-forced on their tokens,
and the unsharded bf16 forward's own noise (batch 4 against each row
alone).  Phase 10's bf16 limits are set from these readings.

Without ``--device cpu`` it needs the card and builds the kernels first.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.training.train_step import grads_of  # noqa: E402

DROP_SEED = 24
DROP_FACTORS = (4.0, 5.0)


def drop_config(factor: float):
    label, arch, _, dtype, layers = cs.MESH_TRAIN[0]
    cfg = cs.mesh_config(label, arch, dtype, layers)
    return dataclasses.replace(cfg, capacity_factor=factor)


def loads(counts: torch.Tensor, cap: int):
    """(largest expert load, capacity, assignments dropped) of per-expert ``counts``."""
    return int(counts.max()), cap, int((counts - cap).clamp(min=0).sum())


def drops_rank(rank, world, device):
    """Each factor's sharded train step on this rank: the loss, the gradients (rank 0) and,
    per MoE layer, what this rank's data shard's capacity drops."""
    import warnings

    from repro_torch.launch.mesh import device_mesh
    from repro_torch.sharding.rules import make_rules

    warnings.filterwarnings("ignore")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        for k in _build.KERNELS:
            _build.load(k)
    rules = make_rules(device_mesh(dev.type, cs.MESH_SHAPE, ("data", "model")))
    out = {}
    for factor in DROP_FACTORS:
        cfg = drop_config(factor)
        api = build_model(cfg)
        seen = []
        dispatch = moe._local_dispatch

        def counted(xt, router, E, K, C_loc, **kw):
            res = dispatch(xt, router, E, K, C_loc, **kw)
            seen.append(loads(res[2][0], C_loc))
            return res

        params = api.init(torch.Generator(device=dev).manual_seed(DROP_SEED), dev, trainable=True,
                          rules=rules)
        batch = {"tokens": cs.mesh_batch(cfg, DROP_SEED, cs.MESH_TRAIN_SHAPE).to(dev)}
        with mock.patch.object(moe, "_local_dispatch", counted):
            loss, _ = api.loss_fn(params, batch, rules)
        grads = grads_of(loss, params)
        full = {k: rules.full(g).cpu() for k, g in grads.items()}
        out[factor] = (float(loss), full if rank == 0 else None, seen)
    return out


def drops(device):
    dev = torch.device(device)
    ranks = run_ranks(drops_rank, cs.MESH_WORLD, (str(dev),), device=dev, timeout=600)
    G = cs.MESH_SHAPE[0]
    for factor in DROP_FACTORS:
        cfg = drop_config(factor)
        api = build_model(cfg)
        seen = []
        global_path = moe._moe_ffn_global

        def routed(params, x, c):
            B, S, D = x.shape
            T = B * S
            probs = torch.softmax((x.reshape(T, D) @ params["router"]).float(), dim=-1)
            top_e = torch.topk(probs, c.experts_per_token, dim=-1).indices.reshape(T, -1)
            per = [torch.bincount(top_e[g * T // G:(g + 1) * T // G].reshape(-1),
                                  minlength=c.num_experts) for g in range(G)]
            seen.append((loads(sum(per), moe.expert_capacity(T, c)),
                         [loads(p, moe.expert_capacity(T // G, c)) for p in per]))
            return global_path(params, x, c)

        params = api.init(torch.Generator(device=dev).manual_seed(DROP_SEED), dev, trainable=True)
        batch = {"tokens": cs.mesh_batch(cfg, DROP_SEED, cs.MESH_TRAIN_SHAPE).to(dev)}
        with mock.patch.object(moe, "_moe_ffn_global", routed):
            loss, _ = api.loss_fn(params, batch)
        grads = grads_of(loss, params)
        got_loss, got, _ = ranks[0][factor]
        print(f"[drops] capacity factor {factor} ({cfg.num_experts} experts, top-"
              f"{cfg.experts_per_token}, {cs.MESH_TRAIN_SHAPE[0]}x{cs.MESH_TRAIN_SHAPE[1]} tokens, "
              f"seed {DROP_SEED}, mesh {cs.MESH_SHAPE}):")
        for layer, (whole, shards) in enumerate(seen):
            # data shard g's dispatch runs on ranks g*M .. g*M+M-1; rank g*M's reading
            sharded = [ranks[g * cs.MESH_SHAPE[1]][factor][2][layer] for g in range(G)]
            print(f"[drops]   layer {layer}: sharded run, per data shard (largest load, capacity, "
                  f"dropped): {sharded}; unsharded run's routing at the shards' capacity "
                  f"{shards}, at the global capacity {whole}")
        errs = sorted(((got[k] - g.cpu()).abs().max().item() / max(g.abs().max().item(), 1e-30), k)
                      for k, g in grads.items())[::-1]
        print(f"[drops]   loss sharded {got_loss:.7f} unsharded {float(loss):.7f}; largest gradient "
              f"errors relative to each leaf's largest magnitude: "
              + ", ".join(f"{k} {e:.3e}" for e, k in errs[:6]))


def bf16(device, seeds):
    dev = torch.device(device)
    picked = [row for row in cs.MESH_SERVE if row[3] == "bfloat16"]
    serve = [(f"{label} seed {seed}", seed, cs.mesh_config(label, arch, dt, layers))
             for label, arch, _, dt, layers in picked for seed in seeds]
    ranks = run_ranks(cs.mesh_rank, cs.MESH_WORLD, (cs.MESH_SHAPE, str(dev), serve, []),
                      device=dev, timeout=900)
    from repro_torch.serving.engine import Engine, GenerationConfig

    for label, seed, cfg in serve:
        api = build_model(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev)
        prompt = cs.mesh_batch(cfg, seed, (4, cs.PROMPT)).to(dev)
        ref = Engine(api, params, GenerationConfig(max_new_tokens=cs.MESH_NEW,
                                                   cache_len=cs.MESH_CACHE)).generate({"tokens": prompt})
        res = cs.mesh_serve_errors(cfg, params, prompt, ranks[0][label], ref)
        print(f"[bf16] {label}: rows {['%.4e' % e for e in res['rows']]} over steps {res['steps']}; "
              f"parted (row, step, err, top-two gap) "
              f"{[(r, s, round(e, 4), round(g, 4)) for r, s, e, g in res['parted']]}; vs f32 "
              f"sharded {res['anchor'][0]:.4e} unsharded {res['anchor'][1]:.4e} (ratio "
              f"{res['anchor'][0] / res['anchor'][1]:.3f}); noise {res['noise']:.4e}")
        del params, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] not in ("drops", "bf16"):
        print(__doc__, file=sys.stderr)
        return 2
    device = args[args.index("--device") + 1] if "--device" in args else "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            print("torch_mesh_probe: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        _build.build_all()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
        print(f"[{args[0]}] {card}, torch {torch.__version__}")
    if args[0] == "drops":
        drops(device)
    else:
        seeds = [int(s) for s in args[args.index("--seeds") + 1].split(",")] if "--seeds" in args \
            else [21, 22]
        bf16(device, seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
