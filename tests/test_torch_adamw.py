"""The port's AdamW step (``kernels.ops.adamw_update_``; B9 on the card) and the optimizer
that drives it in place.

On the CPU ``ops`` runs the plain version (``kernels/ref.py``), which must match the JAX
package's ``adamw_update`` within 1e-6 over three steps (f32 elementwise arithmetic in
the same order), with f32 and bf16 parameters and f32 gradients on bf16 parameters.  The
state passed in is consumed: the returned state holds the same moment tensors, updated in
place, and the parameters keep their storage and dtype.  On four gloo ranks, a (2, 2)
mesh, the sharded step counts every element once in the norm with one all-reduce, and
equals the unsharded step: bit for bit where no clipping scales the gradients (the
elementwise update is the same arithmetic on each block), within 1e-6 where it does (the
norm's sums run in another order).  ``chip_smoke.hold_at_shape`` holds the step at a
leaf's shape and refuses a wrong one, and ``chip_smoke.hold_adamw`` holds a whole table of
leaves in one step and catches a fault in either of its two calls.  Marked ``gpu``
(skipped without a card): the kernels against the plain version, bit-identical given the
same scalars, gnorm within 1e-6, two calls bit-identical.  JAX is imported inside the CPU tests only, so the card's
machine, which has no JAX, runs ``python -m pytest -m gpu tests/test_torch_adamw.py``.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels import ops, ref
from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_adamw, lr_schedule

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"a": (5, 7), "b/c": (3,), "b/d": (2, 4, 6), "e": (67,)}
DTYPES = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
          "bf16 params, f32 grads": (torch.bfloat16, torch.float32)}


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def np32(t):
    return t.detach().to(torch.float32).numpy()


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("dtypes", list(DTYPES), ids=list(DTYPES))
def test_plain_step_in_place_matches_jax_over_three_steps(dtypes, clip):
    import jax.numpy as jnp

    from repro.training import optimizer as jax_opt

    pdt, gdt = DTYPES[dtypes]
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip)
    jcfg = jax_opt.AdamWConfig(**cfg.__dict__)
    tparams = {k: torch.from_numpy(v.copy()).to(pdt) for k, v in p0.items()}  # JAX may alias v
    jparams = {k: jnp.asarray(v, jdt[pdt]) for k, v in p0.items()}
    tstate, jstate = init_adamw(tparams), jax_opt.init_adamw(jparams)
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) * 3 for k, s in SHAPES.items()}
        tg = {k: torch.from_numpy(v).to(gdt) for k, v in g.items()}
        jg = {k: jnp.asarray(v, jdt[gdt]) for k, v in g.items()}
        _, tstate, tm = adamw_update(cfg, tparams, tg, tstate)
        jparams, jstate, jm = jax_opt.adamw_update(jcfg, jparams, jg, jstate)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for k in SHAPES:
            assert tparams[k].dtype == pdt
            for got, want in ((tparams[k], jparams[k]), (tstate.m[k], jstate.m[k]),
                              (tstate.v[k], jstate.v[k])):
                np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=1e-6,
                                           atol=1e-6)
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


def test_the_state_passed_in_is_updated_in_place():
    params = {"w": torch.ones(6, 5, dtype=torch.bfloat16), "b": torch.zeros(5)}
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    state = init_adamw(params)
    moments = {k: (state.m[k], state.v[k], state.m[k].data_ptr(), state.v[k].data_ptr())
               for k in params}
    grads = {k: torch.full(p.shape, 0.5) for k, p in params.items()}
    out, new, metrics = adamw_update(AdamWConfig(), params, grads, state)
    assert out is params and int(new.step) == 1 and int(state.step) == 0
    for k, p in params.items():
        m, v, mp, vp = moments[k]
        assert p.data_ptr() == ptrs[k] and p.dtype == (torch.bfloat16 if k == "w" else torch.float32)
        assert new.m[k] is m and new.v[k] is v and m.data_ptr() == mp and v.data_ptr() == vp
        assert float(m.abs().max()) > 0 and float(v.abs().max()) > 0  # written in place
    assert float(metrics["grad_norm"]) == pytest.approx(0.5 * np.sqrt(35.0), rel=1e-6)


def test_step_launches_count_the_tables():
    assert adamw_mod.step_launches(27) == {"adamw_norm": 1, "adamw_norm_finish": 1,
                                           "adamw_update": 1}
    assert adamw_mod.step_launches(adamw_mod.MAX_LEAVES + 1) == {
        "adamw_norm": 2, "adamw_norm_finish": 1, "adamw_update": 2}


def test_cpu_step_launches_no_kernel_and_the_kernel_wrapper_refuses_cpu_tensors():
    p, g = [torch.ones(4)], [torch.ones(4)]
    m, v = [torch.zeros(4)], [torch.zeros(4)]
    one = torch.ones(())
    kw = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    ops.reset_launch_counts()
    gnorm, scale = ops.adamw_update_(p, g, m, v, one * 1e-3, one * 0.1, one * 0.05, **kw)
    assert not any(ops.launch_counts().values())
    assert float(gnorm) == pytest.approx(2.0) and float(scale) == pytest.approx(0.5)
    with pytest.raises(ValueError, match="CUDA"):
        adamw_mod.adamw_update_(p, g, m, v, one, one, one, **kw)


# ---------------------------------------------------------------------------
# the mesh: four gloo ranks on a (data 2, model 2) mesh
# ---------------------------------------------------------------------------

# leaves placed as the rules place parameters: sharded on the model axis, sharded on
# both, replicated everywhere, sharded on a later dim; (shape, placements by name)
MESH_LEAVES = {"emb": ((8, 6), ("R", "S0")), "both": ((4, 6), ("S0", "S1")),
               "norm": ((6,), ("R", "R")), "proj": ((3, 4, 8), ("R", "S2"))}


def _placements(names):
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if n == "R" else Shard(int(n[1])) for n in names]


def _mesh_cases(rank, world, cases):
    return {name: _mesh_steps(clip, pdt) for name, clip, pdt in cases}


def _mesh_steps(clip, pdt):
    """Three steps of ``adamw_update`` on the mesh and unsharded from the same numbers;
    -> (sharded params, m, v and metrics gathered whole, the unsharded ones, the
    optimizer's collectives of a step)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.dryrun import CollectiveCounter
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.sharding.rules import local_block, make_rules

    rules = make_rules(device_mesh("cpu", (2, 2), ("data", "model")))
    rng = np.random.default_rng(1)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip)

    def placed(t, names):
        pl = _placements(names)
        return DTensor.from_local(local_block(t, rules.mesh, pl), rules.mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    whole = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(pdt)
             for k, (s, _) in MESH_LEAVES.items()}
    sharded = {k: placed(t.clone(), MESH_LEAVES[k][1]) for k, t in whole.items()}
    states = {"whole": init_adamw(whole), "sharded": init_adamw(sharded)}
    metrics = {"whole": [], "sharded": []}
    counts = None
    for _ in range(3):
        g = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 3).to(pdt)
             for k, (s, _) in MESH_LEAVES.items()}
        _, states["whole"], m = adamw_update(cfg, whole, g, states["whole"])
        metrics["whole"].append({k: float(v) for k, v in m.items()})
        counter = CollectiveCounter(bytes_accessed=False)
        with counter.mode:
            _, states["sharded"], m = adamw_update(
                cfg, sharded, {k: placed(t, MESH_LEAVES[k][1]) for k, t in g.items()},
                states["sharded"])
        counts = dict(counter.counts)
        metrics["sharded"].append({k: float(v) for k, v in m.items()})
    out = {}
    for name, params in (("whole", whole), ("sharded", sharded)):
        st = states[name]
        out[name] = {k: [rules.full(t).clone() for t in (params[k], st.m[k], st.v[k])]
                     for k in MESH_LEAVES}
    return out, metrics, counts


@pytest.fixture(scope="module")
def mesh_runs():
    from repro_torch.launch.mesh import run_ranks

    cases = (("unclipped", 1e3, torch.float32), ("clipped", 1.0, torch.float32),
             ("unclipped bf16", 1e3, torch.bfloat16))
    ranks = run_ranks(_mesh_cases, 4, (cases,), device="cpu", timeout=300)
    return {name: [r[name] for r in ranks] for name, _, _ in cases}


@pytest.mark.parametrize("case", ["unclipped", "clipped", "unclipped bf16"])
def test_mesh_step_equals_the_unsharded_step(mesh_runs, case):
    for out, metrics, counts in mesh_runs[case]:
        # one all-reduce a step: the norm's sum over the ranks, each element counted once
        assert {k: n for k, n in counts.items() if n} == {"all-reduce": 1}
        for sm, wm in zip(metrics["sharded"], metrics["whole"]):
            assert sm["lr"] == wm["lr"]
            assert sm["grad_norm"] == pytest.approx(wm["grad_norm"], rel=1e-6)
        for k in MESH_LEAVES:
            for got, want in zip(out["sharded"][k], out["whole"][k]):
                if case.startswith("unclipped"):  # the same arithmetic on every block
                    assert torch.equal(got, want), k
                else:
                    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# chip_smoke.py holds the step at a launched leaf's shape
# ---------------------------------------------------------------------------

HOLD_KEYS = [((5, 7), torch.float32, torch.float32), ((3, 67), torch.bfloat16, torch.bfloat16),
             ((2, 4, 9), torch.bfloat16, torch.float32), ((13,), torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("key", HOLD_KEYS, ids=[str(k[0]) for k in HOLD_KEYS])
def test_chip_smoke_holds_the_step_at_a_leaf_shape(key, monkeypatch):
    cs = chip_smoke()
    gen = torch.Generator().manual_seed(0)
    assert cs.hold_at_shape("adamw_update_", key, "cpu", gen) == 0.0
    right = ops.adamw_update_

    def wrong(p, *a, **kw):  # one element of the first leaf off
        out = right(p, *a, **kw)
        p[0].view(-1)[0] += 1.0
        return out

    monkeypatch.setattr(ops, "adamw_update_", wrong)
    with pytest.raises(AssertionError, match="held where it was launched"):
        cs.hold_at_shape("adamw_update_", key, "cpu", gen)


@pytest.mark.parametrize("fault_call", [None, 1, 2], ids=["right", "first call off", "second call off"])
def test_chip_smoke_holds_a_whole_table_in_one_step(fault_call, monkeypatch):
    # many leaves in one table (several launches on the card), every (p, g) dtype pair and a
    # leaf 2 bytes off 16, held as phase 5 holds a training run's table: the readings are
    # measured, and a fault in either of the two calls is caught
    cs = chip_smoke()
    leaves = [((1 + 37 * i, 3 + i % 5), (torch.float32, torch.bfloat16)[i % 2],
               (torch.float32, torch.bfloat16)[(i // 2) % 2]) for i in range(40)]
    leaves.append(((4097,), torch.bfloat16, torch.bfloat16))
    make = cs.adamw_maker(leaves, "cpu", 26)
    table = cs.adamw_table(make, len(leaves))
    off = torch.empty(4097 + 8, dtype=torch.bfloat16)[1:4098]
    table[0][-1] = off.copy_(table[0][-1])
    right, calls = ops.adamw_update_, []

    def step(p, *a, **kw):
        out = right(p, *a, **kw)
        calls.append(1)
        if len(calls) == fault_call:
            p[7].view(-1)[3] += 0.5
        return out

    monkeypatch.setattr(ops, "adamw_update_", step)
    if fault_call is None:
        assert cs.hold_adamw("table", table, make, "cpu") == (0.0, 0.0, 0.0)
        assert table[0][-1].data_ptr() == off.data_ptr()
    else:
        with pytest.raises(AssertionError, match=f"table: call {fault_call}, leaf 7 .* p differs"):
            cs.hold_adamw("table", table, make, "cpu")
    assert len(calls) == (2 if fault_call is None else fault_call)


def test_chip_smoke_counts_the_optimizer_steps():
    from repro_torch.configs import get_config

    cs = chip_smoke()
    cfg = get_config("granite-moe-3b-a800m")
    base = cs.path_launches(cfg, 0, 0, train_steps=2)
    with_opt = cs.path_launches(cfg, 0, 0, train_steps=2, opt_steps=2)
    assert with_opt == {**base, "adamw_norm": 2, "adamw_norm_finish": 2, "adamw_update": 2}
    assert base["adamw_update"] == 0 and base.keys() == ops.launch_counts().keys()


def test_the_launch_count_reads_the_leaves_a_step_updates():
    """``path_launches`` counts the leaves of the abstract parameters: those of every
    config are the trainable tree's."""
    from repro_torch.configs import all_configs
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import flat_named, named_params

    for cfg in all_configs().values():
        api = build_model(cfg.reduced())
        trained = named_params(api.init(torch.Generator().manual_seed(0), "cpu", trainable=True))
        assert trained.keys() == flat_named(build_model(cfg).abstract_params()).keys(), cfg.name


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_equal_the_plain_step_and_repeat_bit_for_bit(cuda):
    """40 leaves (two tables), every (p, g) dtype pair, tails and an unaligned leaf."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    leaves = []
    for i in range(40):
        pdt = (torch.float32, torch.bfloat16)[i % 2]
        gdt = (torch.float32, torch.bfloat16)[(i // 2) % 2]
        leaves.append(((1 + 37 * i, 3 + i % 5), pdt, gdt))
    leaves.append(((4097,), torch.bfloat16, torch.bfloat16))
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    step = torch.tensor(3, dtype=torch.int32, device=cuda)
    lr = lr_schedule(cfg, step)
    bc1, bc2 = (1 - b ** step.to(torch.float32) for b in (cfg.beta1, cfg.beta2))
    kw = dict(beta1=cfg.beta1, beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay,
              grad_clip=cfg.grad_clip)

    def fresh(shape, dtype, scale=1.0, offset=0):
        n = int(np.prod(shape))
        t = torch.randn(n + offset, generator=gen, device=cuda) * scale
        return t.to(dtype)[offset:].view(shape)

    ps = [fresh(s, p) for s, p, _ in leaves]
    ps[-1] = fresh(leaves[-1][0], torch.bfloat16, offset=1)  # 2 bytes off 16
    gs = [fresh(s, g, 3.0) for s, _, g in leaves]
    ms = [fresh(s, torch.float32, 0.01) for s, _, _ in leaves]
    vs = [fresh(s, torch.float32).square() * 1e-4 for s, _, _ in leaves]
    runs = []
    for _ in range(2):
        p2, m2, v2 = ([t.clone() for t in ts] for ts in (ps, ms, vs))
        if _ == 0:
            ops.reset_launch_counts()
        gnorm, scale = ops.adamw_update_(p2, gs, m2, v2, lr, bc1, bc2, **kw)
        runs.append((gnorm.clone(), scale.clone(), p2, m2, v2))
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    assert counts == {k: 2 * n for k, n in adamw_mod.step_launches(len(leaves)).items()}
    first, second = runs
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    for a, b in zip(first[2:], second[2:]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    want = torch.sqrt(sum(g.float().square().sum() for g in gs))
    assert abs(float(first[0]) - float(want)) <= 1e-6 * float(want)
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        p3, m3, v3 = p.clone(), m.clone(), v.clone()
        ref.adamw_leaf_ref(p3, g, m3, v3, first[1], lr, bc1, bc2, beta1=cfg.beta1,
                           beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)
        assert torch.equal(p3, first[2][i]) and torch.equal(m3, first[3][i]), i
        assert torch.equal(v3, first[4][i]), i
