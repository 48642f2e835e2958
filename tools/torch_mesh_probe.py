#!/usr/bin/env python3
"""Probes of the multi-device layer: gloo ranks that share one card (or the CPU).

    python3 tools/torch_mesh_probe.py drops [--device cpu]
    python3 tools/torch_mesh_probe.py bf16 [--seeds 21,22,...] [--arch a,b,...] [--device cpu]
    python3 tools/torch_mesh_probe.py runs [--arch a,b,...] [--device cpu]
    python3 tools/torch_mesh_probe.py grads [--arch a,b,...] [--depths 4,12] [--device cpu]

``drops``: the train step of ``chip_smoke.py`` phase 10's reduced granite
(10 experts, top-2, 4 x 64 tokens, seed 24) on its (data 2, model 3) mesh,
once at the reduced config's capacity factor 4.0 and once at E / K = 5,
which drops nothing.  For each MoE layer it prints each data shard's
largest expert load, its capacity and the assignments it drops, as the
ranks' dispatch counts them, and the same over the unsharded run's own
routing at the data shards' capacity and at the global one; then the loss
and the largest gradient error of each leaf, sharded against unsharded,
relative to the leaf's largest magnitude.

``bf16``: phase 10's bf16 generations (granite at 8 layers, llama3.2-1b,
mamba2-130m, hymba-1.5b, whisper-medium over 1500 stub frames; full width,
4 x (128 + 9); ``--arch`` keeps those of the named architectures) on the
mesh for each seed, held as phase 10 holds them
(``chip_smoke.mesh_serve_errors``): each row's logit error against the
unsharded run until its tokens part, the errors of both runs against an
f32 forward of the same weights teacher-forced on their tokens, and the
unsharded bf16 forward's own noise (batch 4 against each row alone).
Phase 10's bf16 limits are set from these readings.

``runs``: phase 10's serving runs (every dtype) and train steps of the
named architectures, alone, held as phase 10 holds them: every rank's
launches against ``chip_smoke.path_launches``, the f32 generations and
the train steps (on rank 0) against the same weights unsharded, and every (kernel,
shape) a rank launched against its plain version at once; the bf16
generations' readings are printed, not held (their limits come from
``bf16``); each rank's peak memory and walls.

``grads``: phase 10's train steps of the named architectures (and
mamba2-130m's at ``--depths`` layers) on the mesh, each leaf's gradient
error relative to its largest magnitude against the unsharded step on the
whole batch, on each data shard's half (the shapes a data rank computes,
averaged) and the whole-batch step run again, and the halves against the
whole: how far the card's own f32 arithmetic moves a gradient through
other shapes of the same products.

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
        batch = cs.on(cs.mesh_batch(cfg, DROP_SEED, cs.MESH_TRAIN_SHAPE), dev)
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
        batch = cs.on(cs.mesh_batch(cfg, DROP_SEED, cs.MESH_TRAIN_SHAPE), dev)
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


def picked(rows, archs):
    return [row for row in rows if archs is None or row[1] in archs]


def readings(res):
    return (f"rows {['%.4e' % e for e in res['rows']]} over steps {res['steps']}; parted (row, "
            f"step, err, top-two gap) {[(r, s, round(e, 4), round(g, 4)) for r, s, e, g in res['parted']]}"
            + ("" if "anchor" not in res else
               f"; vs f32 sharded {res['anchor'][0]:.4e} unsharded {res['anchor'][1]:.4e} (ratio "
               f"{res['anchor'][0] / res['anchor'][1]:.3f}); noise {res['noise']:.4e}"))


def bf16(device, seeds, archs):
    dev = torch.device(device)
    rows = [row for row in picked(cs.MESH_SERVE, archs) if row[3] == "bfloat16"]
    serve = [(f"{label} seed {seed}", seed, cs.mesh_config(label, arch, dt, layers))
             for label, arch, _, dt, layers in rows for seed in seeds]
    ranks = run_ranks(cs.mesh_rank, cs.MESH_WORLD, (cs.MESH_SHAPE, str(dev), serve, [], []),
                      device=dev, timeout=1800)
    for label, seed, cfg in serve:
        res = cs.mesh_reference(seed, cfg, ranks[0][label], dev)
        print(f"[bf16] {label}: {readings(res)}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def runs(device, archs):
    import time

    dev = torch.device(device)
    cfgs = {label: cs.mesh_config(label, arch, dt, layers)
            for label, arch, _, dt, layers in picked(cs.MESH_SERVE + cs.MESH_TRAIN, archs)}
    serve = [(label, seed, cfgs[label]) for label, _, seed, _, _ in picked(cs.MESH_SERVE, archs)]
    train = [(label, seed, cfgs[label]) for label, _, seed, _, _ in picked(cs.MESH_TRAIN, archs)]
    t0, t0_host = time.perf_counter(), time.time()
    ranks = run_ranks(cs.mesh_rank, cs.MESH_WORLD, (cs.MESH_SHAPE, str(dev), serve, train, []),
                      device=dev, timeout=1800)
    print(f"[runs] the ranks' runs took {time.perf_counter() - t0:.1f}s: "
          + cs.mesh_timeline(ranks[0]["spans"], ranks[0]["walls"], t0_host, time.time()))
    cs.mesh_launches(ranks, cfgs)
    print("[runs] every rank's launches as path_launches gives them: " + "; ".join(
        f"{k} {dict((n, c) for n, c in v.items() if c)}" for k, v in ranks[0]["launches"].items()))
    for r, res in enumerate(ranks):
        print(f"[runs] rank {r}: peak GiB {res['peak_gib']}; walls s {res['walls']}")
    for what, kinds in ranks[0]["collectives"].items():
        print(f"[runs] rank 0 collectives of one {what}: {kinds}")
    for label, seed, cfg in serve:
        if cfg.dtype == "float32":
            print(cs.hold_mesh_generate(label, seed, cfg, ranks[0][label], dev))
        else:
            res = cs.mesh_reference(seed, cfg, ranks[0][label], dev)
            print(f"[runs] generate {label}: {readings(res)}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for label, _, _ in train:  # held on rank 0
        print(ranks[0][f"train {label}"])
    gen = torch.Generator(device=dev).manual_seed(0)
    cs.hold_unchecked("runs", set().union(*(res["shapes"] for res in ranks)), {},
                      lambda k, key: cs.hold_at_shape(k, key, dev, gen))


def rel_errs(got, want):
    """Each leaf's max abs error of ``got`` against ``want``, relative to the leaf's largest
    magnitude in ``want``, largest first."""
    return sorted((((got[k] - w).abs().max() / w.abs().max().clamp_min(1e-30)).item(), k)
                  for k, w in want.items())[::-1]


def grads(device, archs, depths):
    """The train steps of phase 10 (and mamba2's at ``depths``) on the mesh against the
    unsharded step on the whole batch, on each data shard's half of it (the shapes a data
    rank computes, the gradients averaged), and the whole-batch step run again."""
    dev = torch.device(device)
    rows = [(label, seed, cs.mesh_config(label, arch, dt, layers))
            for label, arch, seed, dt, layers in picked(cs.MESH_TRAIN, archs)]
    for n in depths:
        label, arch, seed, dt, _ = next(r for r in cs.MESH_TRAIN if r[1] == "mamba2-130m")
        rows.append((f"mamba2-130m {n}L probe", seed, cs.mesh_config(label, arch, dt, n)))
    ranks = run_ranks(cs.mesh_rank, cs.MESH_WORLD, (cs.MESH_SHAPE, str(dev), [], rows, [], False),
                      device=dev, timeout=1800)
    for label, seed, cfg in rows:
        api = build_model(cfg)
        batch = cs.on(cs.mesh_batch(cfg, seed, cs.MESH_TRAIN_SHAPE), dev)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev, trainable=True)

        def step(b):
            loss = api.loss_fn(params, b)[0]
            return float(loss), {k: g.cpu() for k, g in grads_of(loss, params).items()}

        whole, again = step(batch), step(batch)
        G = cs.MESH_SHAPE[0]
        n = cs.MESH_TRAIN_SHAPE[0] // G
        parts = [step({k: v[i * n:(i + 1) * n] for k, v in batch.items()}) for i in range(G)]
        halves = (sum(p[0] for p in parts) / G, {k: sum(p[1][k] for p in parts) / G for k in whole[1]})
        got = ranks[0][f"train {label}"]
        for name, a, b in (("sharded vs whole", got, whole), ("sharded vs halves", got, halves),
                           ("halves vs whole", halves, whole), ("whole vs whole again", again, whole)):
            errs = rel_errs(a[1], b[1])
            print(f"[grads] {label} {name}: loss {abs(a[0] - b[0]):.3e}; grads "
                  + ", ".join(f"{k} {e:.3e}" for e, k in errs[:5]))
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] not in ("drops", "bf16", "runs", "grads"):
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
    archs = set(args[args.index("--arch") + 1].split(",")) if "--arch" in args else None
    if args[0] == "drops":
        drops(device)
    elif args[0] == "runs":
        runs(device, archs)
    elif args[0] == "grads":
        depths = [int(n) for n in args[args.index("--depths") + 1].split(",")] if "--depths" in args \
            else []
        grads(device, archs, depths)
    else:
        seeds = [int(s) for s in args[args.index("--seeds") + 1].split(",")] if "--seeds" in args \
            else [21, 22]
        bf16(device, seeds, archs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
