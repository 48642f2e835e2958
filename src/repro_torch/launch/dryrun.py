"""Dry-run: trace every (arch x shape x mesh) of the production meshes in one process.

Torch twin of ``repro.launch.dryrun``.  One process stands for rank 0 of
the 256 (``--mesh single``, 16 x 16) or 512 (``--mesh multi``, 2 x 16 x 16)
ranks, over torch's ``fake`` process-group backend: collectives return at
once and move nothing.  Parameters, optimizer state, batch and decode state
are fake CPU tensors (``FakeTensorMode``): nothing is allocated, and the
kernels' wrappers take their plain versions.  Each is a DTensor placed by
the rules' specs, so every operation runs on rank 0's local blocks and
every collective the rules issue is recorded.  For each combination the
train step, the prefill or the decode step is traced once, and a JSON
record is written with the JAX record's keys wherever the meaning is the
same:

* ``state_bytes_per_dev`` / ``batch_bytes_per_dev``: analytic bytes per
  device of the (tensor, spec) trees, as JAX's ``tree_bytes_per_device``;
* ``collectives``: count and result bytes by kind (all-gather, all-reduce,
  reduce-scatter, all-to-all, collective-permute) of rank 0's collectives;
* ``cost_analysis``: rank 0's FLOPs (``torch.utils.flop_counter``) and the
  bytes its operations read and write, each operation counted alone (no
  fusion: XLA's "bytes accessed" after fusion has no counterpart);
* ``layer_body_cost``: null.  JAX's ``cost_analysis`` counts a ``while``
  body once, so it calibrates one layer's cost by compiling two variants
  (repro/launch/dryrun.py:212-238).  The port's depth is a Python loop:
  the counters above see every layer, and nothing needs calibrating;
* ``memory_analysis``: rank 0's peak of live bytes over the traced step
  from ``torch.distributed._tools.mem_tracker.MemTracker`` (XLA's
  ``compiled.memory_analysis()`` has no counterpart); a train step's layers
  are rematerialised where ``remat`` (the config's, or ``--remat``) holds, as
  in JAX, and the peak is that of the rematerialised step;
* ``remat``: whether the layers were rematerialised;
* ``roofline``: compute, memory and collective times per device against
  the constants below, and the dominant one.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
          --shape train_4k --mesh single --out results/dryrun_torch
      PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

JAX's flags but one: ``--save-hlo`` (there is no HLO).  ``--remat on|off``
overrides the config's ``remat``, as JAX's does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import warnings
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import INPUT_SHAPES, all_configs, get_config
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.launch.specs import (
    decode_shardings,
    decode_specs,
    input_shardings,
    input_specs,
    uses_sliding_window,
)
from repro_torch.models.layers import ParamTree, map_schema
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import block_of, make_rules
from repro_torch.training.optimizer import (
    AdamWConfig,
    abstract_adamw,
    adamw_state_specs,
    init_adamw,
)
from repro_torch.training.train_step import TrainState, make_train_step

# --- NVIDIA H100 80GB HBM3 (SXM, 700 W) data-sheet figures, per card ---------
PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
HBM_BW = 3.35e12  # bytes/s
HBM_BYTES = 80e9
# The production meshes put 16 cards on the model axis; on 8-card nodes that
# axis spans two nodes, so its collectives run at the inter-node rate: one
# 400 Gb/s NDR InfiniBand port per card (DGX H100), 50 GB/s each way.
# (NVLink 4 inside a node: 900 GB/s per card, both ways together.)
LINK_BW = 50e9  # bytes/s per card
# JAX switches on FSDP where the model-sharded train state exceeds 11 GB of a
# 16 GB TPU v5e; the port takes the same share of the card's 80 GB.
FSDP_STATE_BYTES = 11e9 / 16e9 * HBM_BYTES

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("reduce_scatter", "reduce-scatter"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"), ("send", "collective-permute"),
          ("recv", "collective-permute"))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _flat_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _flat_tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _flat_tensors(x)]
    return []


def _leaves(tree):
    """Leaves of a state tree (dicts, NamedTuples, TrainState) or of its spec tree, in one
    order: a spec (a plain tuple) is a leaf."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, TrainState):
        return _leaves(tree.params) + _leaves(tree.opt)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def tree_bytes_per_device(abstract, specs, mesh_sizes: Dict[str, int]) -> float:
    """Analytic per-device bytes of a (tensor, spec) tree: each leaf's bytes over the
    number of its shards.  None leaves count nothing; a Python int (a decode state's
    position) is JAX's int32 scalar."""
    leaves, spec_leaves = _leaves(abstract), _leaves(specs)
    assert len(leaves) == len(spec_leaves), (len(leaves), len(spec_leaves))
    total = 0.0
    for leaf, spec in zip(leaves, spec_leaves):
        if leaf is None:
            continue
        n, size = (1, 4) if isinstance(leaf, int) else (leaf.numel(), leaf.element_size())
        shards = 1
        for entry in spec or ():
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    shards *= mesh_sizes[a]
        total += n * size / shards
    return total


class CollectiveCounter:
    """A dispatch mode (``.mode``) that counts this rank's collectives (count and result
    bytes by kind) and, with ``bytes_accessed``, the bytes every other operation reads
    and writes."""

    def __init__(self, bytes_accessed: bool = True):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self.collectives["count"] = 0
        self.counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.count_bytes = bytes_accessed
        self.bytes_accessed = 0.0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter.see(func, args, out)
                return out

        self.mode = Mode()

    def see(self, func, args, out) -> None:
        name = str(func)
        if func.namespace in ("_c10d_functional", "c10d", "c10d_functional"):
            if "wait" in name:
                return
            kind = next((k for key, k in _KINDS if key in name), None)
            if kind is None:
                return
            # the result: a functional collective returns it; c10d's in-place ones take it first
            res = out if func.namespace != "c10d" else args[0]
            self.collectives[kind] += sum(_nbytes(t) for t in _flat_tensors(res))
            self.collectives["count"] += 1
            self.counts[kind] += 1
            return
        if not self.count_bytes:
            return
        if func._schema.is_mutable is False and any(
            r.alias_info is not None for r in func._schema.returns
        ):
            return  # views move no bytes
        self.bytes_accessed += sum(_nbytes(t) for t in _flat_tensors(list(args)))
        self.bytes_accessed += sum(_nbytes(t) for t in _flat_tensors(out))


def _fake_params(api, rules, trainable: bool) -> ParamTree:
    """The parameters as DTensors over fake local blocks (nothing allocated)."""
    from torch.distributed.tensor import DTensor

    def leaf(p):
        placements = rules.placements(p.shape, p.dims)
        local, _ = block_of(p.shape, rules.mesh, placements)
        return DTensor.from_local(torch.empty(local, dtype=api.dtype), rules.mesh, placements,
                                  run_check=False, shape=torch.Size(p.shape),
                                  stride=torch.empty(p.shape, device="meta").stride())

    return ParamTree(map_schema(leaf, api.schema), trainable)


def _fake_batch(abstract: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in abstract.items()}


def _trace(cfg, shape, rules, api) -> Dict[str, Any]:
    """Build the step for this shape's kind, run it once on fake tensors under the
    counters; -> the record's extras and measurements."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    mesh_sizes = dict(rules.axis_sizes)
    params_abs, param_specs = api.abstract_params(), api.param_specs(rules)
    extras: Dict[str, Any] = {}
    counter = CollectiveCounter()
    peak: Optional[float] = None
    with FakeTensorMode(allow_non_fake_inputs=True):
        flops = FlopCounterMode(display=False)
        if shape.kind == "train":
            state_abs = TrainState(params_abs, abstract_adamw(params_abs))
            state_specs = TrainState(param_specs, adamw_state_specs(param_specs))
            batch_abs = input_specs(cfg, shape)
            extras["state_bytes_per_dev"] = tree_bytes_per_device(state_abs, state_specs, mesh_sizes)
            extras["batch_bytes_per_dev"] = tree_bytes_per_device(
                batch_abs, input_shardings(cfg, shape, rules), mesh_sizes)
            tokens = shape.global_batch * (cfg.decoder_seq if cfg.family == "audio" else shape.seq_len)
            extras["model_flops"] = 6.0 * api.active_param_count() * tokens
            params = _fake_params(api, rules, trainable=True)
            state = TrainState(params, init_adamw(params))
            step = make_train_step(api, AdamWConfig(), rules)
            batch = _fake_batch(batch_abs)
            run = lambda: step(state, batch)  # noqa: E731
        elif shape.kind == "prefill":
            batch_abs = input_specs(cfg, shape)
            extras["state_bytes_per_dev"] = tree_bytes_per_device(params_abs, param_specs, mesh_sizes)
            extras["batch_bytes_per_dev"] = tree_bytes_per_device(
                batch_abs, input_shardings(cfg, shape, rules), mesh_sizes)
            extras["model_flops"] = 2.0 * api.active_param_count() * shape.global_batch * shape.seq_len
            params = _fake_params(api, rules, trainable=False)
            batch = _fake_batch(batch_abs)

            def run():
                with torch.no_grad():
                    return api.prefill(params, batch, rules=rules)
        else:  # decode
            sw = cfg.sliding_window if uses_sliding_window(cfg, shape) else 0
            extras["sliding_window"] = sw
            state_abs, token_abs = decode_specs(api, shape)
            state_specs, _ = decode_shardings(api, shape, rules)
            extras["state_bytes_per_dev"] = tree_bytes_per_device(
                params_abs, param_specs, mesh_sizes) + tree_bytes_per_device(
                state_abs, state_specs, mesh_sizes)
            extras["model_flops"] = 2.0 * api.active_param_count() * shape.global_batch
            params = _fake_params(api, rules, trainable=False)
            B, S = shape.global_batch, shape.seq_len
            dstate = api.init_decode_state(B, S, device="cpu", rules=rules)
            # decode the cache's last position, past a full prompt
            dstate = dstate._replace(pos=S - 1)
            token = torch.zeros(token_abs.shape, dtype=token_abs.dtype)

            def run():
                with torch.no_grad():
                    return api.decode_step(params, dstate, token, sliding_window=sw, rules=rules)

        try:
            from torch.distributed._tools.mem_tracker import MemTracker

            tracker = MemTracker()
            tracker.track_external(params)
        except Exception:  # noqa: BLE001 - the record says the peak was not measured
            tracker = None
        t0 = time.time()
        with flops, counter.mode:
            if tracker is not None:
                with tracker:
                    run()
                snap = tracker.get_tracker_snapshot("peak")
                peak = float(sum(v.get("Total", 0) for v in snap.values()))
            else:
                run()
        extras["trace_s"] = time.time() - t0
    extras["flops"] = float(flops.get_total_flops())
    extras["bytes"] = counter.bytes_accessed
    extras["collectives"] = dict(counter.collectives)
    extras["peak_bytes"] = peak
    return extras


def run_one(arch: str, shape_name: str, multi_pod: bool, fsdp: Optional[bool] = None,
            remat: Optional[bool] = None) -> Dict[str, Any]:
    cfg = get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = INPUT_SHAPES[shape_name]
    init_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    api = build_model(cfg)
    if fsdp is None:
        # FSDP where the model-sharded train state would not leave headroom on the card
        probe = make_rules(mesh, fsdp=False)
        params_abs, specs = api.abstract_params(), api.param_specs(probe)
        state_bytes = tree_bytes_per_device(
            TrainState(params_abs, abstract_adamw(params_abs)),
            TrainState(specs, adamw_state_specs(specs)), dict(probe.axis_sizes))
        fsdp = state_bytes > FSDP_STATE_BYTES
    rules = make_rules(mesh, fsdp=fsdp)
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n_dev,
        "fsdp": fsdp,
        "params": api.param_count(),
        "active_params": api.active_param_count(),
        "kind": shape.kind,
        "remat": cfg.remat,
    }
    t0 = time.time()
    extras = _trace(cfg, shape, rules, api)
    rec["lower_s"] = time.time() - t0
    flops_dev, bytes_dev = extras.pop("flops"), extras.pop("bytes")
    col = extras.pop("collectives")
    peak = extras.pop("peak_bytes")
    rec.update(extras)
    rec["memory_analysis"] = {"peak_bytes": peak} if peak is not None else {
        "error": "MemTracker did not run under the fake mode: state and batch bytes are analytic only"}
    rec["cost_analysis"] = {"flops": flops_dev, "bytes_accessed": bytes_dev}
    rec["layer_body_cost"] = None  # the loop over depth is traced layer by layer: nothing to calibrate
    rec["collectives"] = col
    col_bytes = sum(v for k, v in col.items() if k != "count")
    compute_t, memory_t, collective_t = flops_dev / PEAK_FLOPS, bytes_dev / HBM_BW, col_bytes / LINK_BW
    rec["roofline"] = {
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": collective_t,
        "dominant": max((("compute", compute_t), ("memory", memory_t),
                         ("collective", collective_t)), key=lambda kv: kv[1])[0],
        "model_flops_ratio": rec.get("model_flops", 0.0) / (flops_dev * n_dev) if flops_dev > 0 else None,
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW, "link_bytes_per_s": LINK_BW,
                      "card": "NVIDIA H100 80GB HBM3 (SXM, 700 W), data sheet"},
    }
    rec["ok"] = True
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*INPUT_SHAPES, None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--remat", default=None, choices=[None, "on", "off"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    warnings.filterwarnings("ignore")
    import logging

    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    os.makedirs(args.out, exist_ok=True)
    archs = sorted(all_configs()) if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    fsdp = None if args.fsdp is None else args.fsdp == "on"
    remat = None if args.remat is None else args.remat == "on"
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tagsuf = f"_{args.tag}" if args.tag else ""
                name = f"{arch}_{shape}_{'multi' if mp else 'single'}{tagsuf}.json"
                path = os.path.join(args.out, name)
                if os.path.exists(path) and not args.tag:
                    print(f"skip {name} (exists)")
                    continue
                print(f"=== {arch} x {shape} x {'2x16x16' if mp else '16x16'} ===", flush=True)
                try:
                    rec = run_one(arch, shape, mp, fsdp=fsdp, remat=remat)
                except Exception as e:  # noqa: BLE001 - recorded, and the next combination runs
                    import traceback

                    rec = {"arch": arch, "shape": shape, "mesh": "2x16x16" if mp else "16x16",
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2)
                if rec.get("ok"):
                    r, c = rec["roofline"], rec["collectives"]
                    print(f"  ok trace={rec['lower_s']:.1f}s flops/dev={rec['cost_analysis']['flops']:.3e} "
                          f"state/dev={rec['state_bytes_per_dev'] / 1e9:.2f}GB "
                          f"collectives={c['count']} ({sum(v for k, v in c.items() if k != 'count') / 1e9:.2f}GB) "
                          f"compute={r['compute_s'] * 1e3:.2f}ms memory={r['memory_s'] * 1e3:.2f}ms "
                          f"collective={r['collective_s'] * 1e3:.2f}ms dominant={r['dominant']}",
                          flush=True)
                else:
                    print(f"  FAILED: {rec['error']}", flush=True)


if __name__ == "__main__":
    main()
