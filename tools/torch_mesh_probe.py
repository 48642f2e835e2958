#!/usr/bin/env python3
"""Probes of the multi-device layer: gloo ranks that share one card (or the CPU).

    python3 tools/torch_mesh_probe.py drops [--device cpu]
    python3 tools/torch_mesh_probe.py bf16 [--seeds 21,22,...] [--arch a,b,...]
                                           [--only serve|train] [--dtype bfloat16,float32]
                                           [--depths 2,4,6] [--device cpu]
    python3 tools/torch_mesh_probe.py runs [--arch a,b,...] [--device cpu]
    python3 tools/torch_mesh_probe.py grads [--arch a,b,...] [--depths 4,12] [--device cpu]
    python3 tools/torch_mesh_probe.py rows [--arch mamba2-130m] [--device cpu]
    python3 tools/torch_mesh_probe.py layers [--seeds 21,31] [--arch mamba2-130m] [--device cpu]

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
mamba2-130m, hymba-1.5b, whisper-medium over 1500 stub frames, internvl2-1b
after 256 stub patches; full width, 4 x (128 + 9)) and bf16 train steps
(granite at 8 layers, mamba2-130m, whisper-medium at 4 + 4 layers; 4 x 64)
on the mesh for each seed (``--arch`` keeps those of the named
architectures), read as phase 10 holds them: each generation's
(``chip_smoke.mesh_serve_errors``) row logit errors against the unsharded
run until its tokens part, the errors of both runs against an f32 forward
of the same weights teacher-forced on their tokens, and the unsharded
bf16 forward's own noise (batch 4 against each row alone); each train
step's (``chip_smoke.mesh_train_errors``, on rank 0) loss and largest
gradient error against the unsharded bf16 step on the whole batch and on
each data shard's rows, and the largest gradient errors of both steps
against the f32 step on the same weights (``--only``: the generations or
the train steps alone).  Phase 10's bf16 limits are set from these
readings.  ``--dtype`` picks the runs of those types (bfloat16 by
default; float32 reads the f32 copies, held to fixed limits, the same
way), and ``--depths`` runs each picked train step at each of those
depths instead of its own.

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
averaged) and the whole-batch step run again, and the halves and each row
alone against the whole: how far the card's own f32 arithmetic moves a gradient through
other shapes of the same products.

``rows``: where the unsharded f32 forward of phase 10's train step (one
card, no mesh; the architecture's f32 row of ``MESH_TRAIN``) departs from
itself between the batch's 4 rows and its first 2 alone: every operation's
output in order (aten operations, and the ``ops`` kernels' as one each),
the first 2 rows' part of the 4-row run against the 2-row run, bit for
bit; it prints the first operations that differ and by how much, and how
many differ in all.

``layers``: where an f32 prefill on the mesh departs from the unsharded one
(phase 10's f32 generation of the architecture, its 4 x 128 prompt, per
seed): each layer's output and the last token's logits, sharded against
unsharded, beside the unsharded run's own departure between the batch's 4
rows and each row alone (the same weights through other shapes of the same
products); each as the max abs difference over the largest magnitude.

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


def bf16(device, seeds, archs, only=None, dtypes=("bfloat16",), depths=()):
    dev = torch.device(device)

    def runs(rows, train=False):
        out = []
        for label, arch, _, dt, layers in picked(rows, archs):
            if dt not in dtypes:
                continue
            for n in (depths if train and depths else [layers]):
                name = label if n == layers else f"{arch} {n}L {dt}"
                out += [(f"{name} seed {seed}", seed, cs.mesh_config(label, arch, dt, n))
                        for seed in seeds]
        return out

    serve = runs(cs.MESH_SERVE) if only in (None, "serve") else []
    train = runs(cs.MESH_TRAIN, True) if only in (None, "train") else []
    ranks = run_ranks(cs.mesh_rank, cs.MESH_WORLD, (cs.MESH_SHAPE, str(dev), serve, train, []),
                      device=dev, timeout=3000)
    for label, seed, cfg in serve:
        res = cs.mesh_reference(seed, cfg, ranks[0][label], dev)
        print(f"[bf16] {label}: {readings(res)}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for label, _, cfg in train:
        res = ranks[0][f"train {label}"]
        anchor = res.get("anchor")
        print(f"[bf16] train {label}: (loss err, largest grad err, its leaf) vs the unsharded "
              f"{cfg.dtype} step on the whole batch {res['whole']}"
              + (f", on each data shard's rows {res['shards']}, those against the whole "
                 f"{res['noise']}" if "shards" in res else "")
              + ("" if anchor is None else
                 f"; vs the f32 step sharded {anchor[0]:.4e} unsharded {anchor[1]:.4e} (ratio "
                 f"{anchor[0] / anchor[1]:.3f})"))


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
    for label, _, cfg in train:  # read on rank 0
        print(cs.mesh_train_line(label, cfg, ranks[0][f"train {label}"]))
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
        label, arch, seed, dt, _ = next(r for r in cs.MESH_TRAIN if r[1] == "mamba2-130m"
                                        and r[3] == "float32")
        rows.append((f"mamba2-130m {n}L probe", seed, cs.mesh_config(label, arch, dt, n)))
    ranks = run_ranks(cs.mesh_rank, cs.MESH_WORLD, (cs.MESH_SHAPE, str(dev), [], rows, [], True),
                      device=dev, timeout=1800)
    for label, seed, cfg in rows:
        api = build_model(cfg)
        batch = cs.on(cs.mesh_batch(cfg, seed, cs.MESH_TRAIN_SHAPE), dev)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev, trainable=True)

        def step(b):
            loss = api.loss_fn(params, b)[0]
            return float(loss), {k: g.cpu() for k, g in grads_of(loss, params).items()}

        whole, again = step(batch), step(batch)

        def split(G):  # the step on G parts of the batch's rows, averaged
            n = cs.MESH_TRAIN_SHAPE[0] // G
            parts = [step({k: v[i * n:(i + 1) * n] for k, v in batch.items()}) for i in range(G)]
            return (sum(p[0] for p in parts) / G,
                    {k: sum(p[1][k] for p in parts) / G for k in whole[1]})

        halves, rows_ = split(cs.MESH_SHAPE[0]), split(cs.MESH_TRAIN_SHAPE[0])
        got = ranks[0][f"train {label}"]
        for name, a, b in (("sharded vs whole", got, whole), ("sharded vs halves", got, halves),
                           ("halves vs whole", halves, whole), ("rows vs whole", rows_, whole),
                           ("whole vs whole again", again, whole)):
            errs = rel_errs(a[1], b[1])
            print(f"[grads] {label} {name}: loss {abs(a[0] - b[0]):.3e}; grads "
                  + ", ".join(f"{k} {e:.3e}" for e, k in errs[:5]))
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()


class Outputs:
    """Every operation's output in order while active: aten operations through a dispatch
    mode, and each ``ops`` entry point's outputs as one operation (what it does inside
    unseen: its kernel fills buffers that the dispatcher sees made empty)."""

    ENTRIES = ("rmsnorm_op", "ssd_intra_chunk_op", "flash_attention_op", "moe_matmul_op",
               "cross_attention_op")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        self.seen, self.inside = [], 0
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if not outer.inside:
                    outer.record(str(func), out)
                return out

        self.mode = Mode()

    def record(self, name, out):
        ts = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
        if ts:
            self.seen.append((name, [t.detach().clone() for t in ts]))

    def entry(self, name, fn):
        def call(*args, **kwargs):
            self.inside += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.inside -= 1
            self.record(f"ops.{name}", out)
            return out
        return call


def rows(device, archs):
    """The unsharded f32 forward on the batch's 4 rows against the same on its first 2."""
    from repro_torch.kernels import ops

    dev = torch.device(device)
    for label, arch, seed, dt, layers in picked(cs.MESH_TRAIN, archs or {"mamba2-130m"}):
        if dt != "float32":
            continue
        cfg = cs.mesh_config(label, arch, dt, layers)
        api = build_model(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev)
        batch = cs.on(cs.mesh_batch(cfg, seed, cs.MESH_TRAIN_SHAPE), dev)
        runs = []
        with torch.no_grad():  # the layers' views made once, so that both runs reuse them
            api.loss_fn(params, batch)
        for n in (cs.MESH_TRAIN_SHAPE[0], cs.MESH_TRAIN_SHAPE[0] // 2):
            rec = Outputs()
            patches = [mock.patch.object(ops, e, rec.entry(e, getattr(ops, e)))
                       for e in Outputs.ENTRIES]
            for p in patches:
                p.start()
            try:
                with torch.no_grad(), rec.mode:
                    api.loss_fn(params, {k: v[:n] for k, v in batch.items()})
            finally:
                mock.patch.stopall()
            runs.append(rec.seen)
        whole, half = runs
        differ = []
        for i, ((name, a), (name2, b)) in enumerate(zip(whole, half)):
            if name != name2:
                raise AssertionError(f"[rows] {label}: operation {i} is {name} on 4 rows, "
                                     f"{name2} on 2")
            for ta, tb in zip(a, b):
                if ta.shape != tb.shape:  # the first 2 rows' part of a batch-major output
                    ta = ta[:tb.shape[0]] if ta.shape[1:] == tb.shape[1:] else None
                if ta is not None and tb.dim() and not torch.equal(ta, tb):  # not the loss
                    err = (ta - tb).abs().max().item()
                    differ.append((i, name, tuple(tb.shape), err, tb.abs().max().item()))
                    break
        n, S = cs.MESH_TRAIN_SHAPE
        print(f"[rows] {label} (L={cfg.num_layers}, {n} vs {n // 2} x {S}): {len(whole)} "
              f"operations; {len(differ)} differ between the {n}-row run's first {n // 2} rows "
              f"and the {n // 2}-row run")
        for i, name, shape, err, scale in differ[:8]:
            print(f"[rows]   operation {i} {name} {shape}: max abs difference {err:.3e} (of "
                  f"{scale:.3e})")
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def prefill_layers(api, params, batch, cfg, rules=None):
    """The last-token logits and each layer's output of a prefill, whole, on the CPU."""
    from repro_torch.models import transformer

    seen = []
    layer = transformer.layer_forward

    def recorded(*args, **kwargs):
        out = layer(*args, **kwargs)
        seen.append((rules.full(out[0]) if rules is not None else out[0]).float().cpu())
        return out

    with torch.no_grad(), mock.patch.object(transformer, "layer_forward", recorded):
        logits = api.prefill(params, batch, cache_len=cs.mesh_cache(cfg), rules=rules)[0]
    return (rules.full(logits) if rules is not None else logits).float().cpu(), seen


def layers_rank(rank, world, device, runs):
    """Each run's sharded prefill on this rank; rank 0 returns its logits and layers."""
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
    for label, seed, cfg in runs:
        api = build_model(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev, rules=rules)
        batch = cs.on(cs.mesh_batch(cfg, seed, (4, cs.PROMPT)), dev)
        res = prefill_layers(api, params, batch, cfg, rules)
        if rank == 0:
            out[label] = res
        del params
    return out


def layers(device, seeds, archs):
    dev = torch.device(device)
    runs = [(f"{label} seed {seed}", seed, cs.mesh_config(label, arch, dt, n))
            for label, arch, _, dt, n in picked(cs.MESH_SERVE, archs or {"mamba2-130m"})
            if dt == "float32" for seed in seeds]
    ranks = run_ranks(layers_rank, cs.MESH_WORLD, (str(dev), runs), device=dev, timeout=1200)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    for label, seed, cfg in runs:
        api = build_model(cfg)
        params = api.init(torch.Generator(device=dev).manual_seed(seed), dev)
        batch = cs.on(cs.mesh_batch(cfg, seed, (4, cs.PROMPT)), dev)
        logits, whole = prefill_layers(api, params, batch, cfg)
        alone = [prefill_layers(api, params, {k: v[i:i + 1] for k, v in batch.items()}, cfg)
                 for i in range(len(batch["tokens"]))]
        got_logits, got = ranks[0][label]
        split = [rel(g, w) for g, w in zip(got, whole)]
        noise = [max(rel(a[1][i], w[r:r + 1]) for r, a in enumerate(alone))
                 for i, w in enumerate(whole)]
        print(f"[layers] {label} (L={cfg.num_layers}, 4x{cs.PROMPT}, prefill): logits sharded vs "
              f"unsharded {rel(got_logits, logits):.3e} ({(got_logits - logits).abs().max():.3e} "
              f"abs); 4 rows vs each alone "
              f"{max(rel(a[0], logits[r:r + 1]) for r, a in enumerate(alone)):.3e}")
        print(f"[layers]   each layer's output, sharded vs unsharded: "
              + " ".join(f"{e:.1e}" for e in split))
        print(f"[layers]   each layer's output, 4 rows vs each alone: "
              + " ".join(f"{e:.1e}" for e in noise))
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    if not args or args[0] not in ("drops", "bf16", "runs", "grads", "rows", "layers"):
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
    elif args[0] == "rows":
        rows(device, archs)
    elif args[0] == "layers":
        layers(device, [int(s) for s in args[args.index("--seeds") + 1].split(",")]
               if "--seeds" in args else [21, 31], archs)
    elif args[0] == "runs":
        runs(device, archs)
    elif args[0] == "grads":
        depths = [int(n) for n in args[args.index("--depths") + 1].split(",")] if "--depths" in args \
            else []
        grads(device, archs, depths)
    else:
        seeds = [int(s) for s in args[args.index("--seeds") + 1].split(",")] if "--seeds" in args \
            else [21, 22]
        bf16(device, seeds, archs, args[args.index("--only") + 1] if "--only" in args else None,
             tuple(args[args.index("--dtype") + 1].split(",")) if "--dtype" in args
             else ("bfloat16",),
             [int(n) for n in args[args.index("--depths") + 1].split(",")] if "--depths" in args
             else [])
    return 0


if __name__ == "__main__":
    sys.exit(main())
