"""The port's copy of the control plane (``repro_torch.core``) under the
reference suite ``tests/test_wire.py``, imports rewritten, each case kept.

The reference suite's own description follows.

Wire-protocol codecs: round-trip identity, schema enforcement, and
the docs/wire-protocol.md worked example validated against the real
codecs (so the documentation cannot rot silently)."""

import json
import math
import re
from pathlib import Path

import pytest

from repro_torch.core import wire
from repro_torch.core.action import (
    Action,
    ActionState,
    AmdahlElasticity,
    Elasticity,
    LinearElasticity,
    ResourceRequest,
    TableElasticity,
    fixed,
)
from repro_torch.core.baselines import FcfsPolicy, StaticDopPolicy
from repro_torch.core.cluster import ApiResourceSpec, CpuNodeSpec, GpuNodeSpec
from repro_torch.core.fairqueue import FairSharePolicy, PartitionQueue
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.managers.basic import BasicResourceManager
from repro_torch.core.managers.cpu import CpuManager
from repro_torch.core.managers.gpu import GpuManager, ServiceSpec
from repro_torch.core.scheduler import Decision, ElasticScheduler, ScheduleResult
from repro_torch.core.shards import PartitionPlan
from repro_torch.core.simulator import EventLoop


def roundtrip(payload):
    """Through the actual byte boundary, not just dict->dict."""
    return wire.loads(wire.dumps(payload))


def wire_equal(a, b):
    """Payload equality modulo NaN (NaN != NaN under ==)."""
    return wire.dumps(a) == wire.dumps(b)


# ---------------------------------------------------------------------------
# actions
# ---------------------------------------------------------------------------


class TestActionCodec:
    def _rich_action(self):
        return Action(
            name="reward",
            cost={
                "cpu": ResourceRequest("cpu", (2, 4, 8)),
                "api": fixed("api", 1),
            },
            key_resource="cpu",
            elasticity=AmdahlElasticity(0.07),
            base_duration=3.25,
            task_id="tenant-a",
            trajectory_id="traj-9",
            weight=2.5,
            service="rm0",
            timeout_s=12.0,
            max_retries=2,
            metadata={"traj_mem_gb": 6.0, "stage": "rollout"},
        )

    def test_round_trip_identity(self):
        a = self._rich_action()
        a.state = ActionState.QUEUED
        a.submit_time = 41.5
        a.attempts = 1
        b = wire.decode_action(roundtrip(wire.encode_action(a)))
        assert wire_equal(wire.encode_action(b), wire.encode_action(a))
        assert b.uid == a.uid
        assert b.cost["cpu"].units == (2, 4, 8)
        assert b.elasticity.serial == pytest.approx(0.07)
        assert b.state is ActionState.QUEUED
        assert b.submit_time == 41.5
        assert b.weight == 2.5
        # schedulable surface identical where it matters for the DP
        assert b.get_dur(4) == a.get_dur(4)
        assert b.scalable and b.key_units() == a.key_units()

    def test_nan_timestamps_survive(self):
        a = Action(name="t", cost={"r": fixed("r")}, trajectory_id="x")
        b = wire.decode_action(roundtrip(wire.encode_action(a)))
        assert math.isnan(b.submit_time) and math.isnan(b.finish_time)

    def test_callables_do_not_cross(self):
        a = Action(
            name="t", cost={"r": fixed("r")}, trajectory_id="x",
            fn=lambda: None, duration_sampler=lambda m: 1.0,
        )
        b = wire.decode_action(wire.encode_action(a))
        assert b.fn is None and b.duration_sampler is None

    def test_metadata_filtered_to_scalars(self):
        a = Action(
            name="t", cost={"r": fixed("r")}, trajectory_id="x",
            metadata={"traj_mem_gb": 2.0, "_dp_durs": ((1,), (1.0,)),
                      "blob": object(), "tag": "ok"},
        )
        b = wire.decode_action(wire.encode_action(a))
        assert b.metadata == {"traj_mem_gb": 2.0, "tag": "ok"}

    @pytest.mark.parametrize(
        "el",
        [
            AmdahlElasticity(0.12),
            TableElasticity(((1, 1.0), (4, 0.8), (8, 0.6))),
            LinearElasticity(),
        ],
    )
    def test_elasticity_models(self, el):
        back = wire.decode_elasticity(roundtrip(wire.encode_elasticity(el)))
        for m in (1, 2, 4, 8):
            assert back.ratio(m) == pytest.approx(el.ratio(m))

    def test_custom_elasticity_rejected(self):
        class Weird(Elasticity):
            def ratio(self, m):
                return 1.0

        with pytest.raises(wire.WireError, match="not wire-serializable"):
            wire.encode_elasticity(Weird())


# ---------------------------------------------------------------------------
# envelopes / schema enforcement
# ---------------------------------------------------------------------------


class TestSchema:
    def test_version_mismatch_rejected(self):
        p = wire.encode_action(Action(name="t", cost={}, trajectory_id="x"))
        p["v"] = wire.WIRE_VERSION + 1
        with pytest.raises(wire.WireError, match="wire version"):
            wire.decode_action(p)

    def test_kind_mismatch_rejected(self):
        p = wire.encode_action(Action(name="t", cost={}, trajectory_id="x"))
        with pytest.raises(wire.WireError, match="expected kind"):
            wire.decode_task_shard(p)

    def test_missing_field_is_wire_error(self):
        p = wire.encode_action(Action(name="t", cost={}, trajectory_id="x"))
        del p["cost"]
        with pytest.raises(wire.WireError, match="missing required field"):
            wire.decode_action(p)

    def test_unknown_fields_ignored(self):
        """Additive evolution: decoders skip fields they don't know."""
        p = wire.encode_action(Action(name="t", cost={}, trajectory_id="x"))
        p["future_field"] = {"anything": 1}
        wire.decode_action(p)  # must not raise

    def test_malformed_blob_is_wire_error(self):
        with pytest.raises(wire.WireError, match="malformed"):
            wire.loads("{not json")

    def test_non_dict_payload_rejected(self):
        with pytest.raises(wire.WireError, match="must be a dict"):
            wire.expect([1, 2], "action")

    def test_unknown_action_state_rejected(self):
        p = wire.encode_action(Action(name="t", cost={}, trajectory_id="x"))
        p["state"] = "levitating"
        with pytest.raises(wire.WireError, match="unknown state"):
            wire.decode_action(p)


# ---------------------------------------------------------------------------
# plans / decisions (uid re-binding)
# ---------------------------------------------------------------------------


class TestPlanCodec:
    def test_plan_round_trip_rebinds_live_actions(self):
        a = Action(name="a", cost={"r": fixed("r", 2)}, trajectory_id="t0")
        b = Action(name="b", cost={"r": ResourceRequest("r", (1, 4))},
                   trajectory_id="t1")
        plan = PartitionPlan(
            "r",
            result=ScheduleResult(
                decisions=[Decision(a, {"r": 2}), Decision(b, {"r": 4})],
                objective=7.5,
                evicted=1,
            ),
            held=2,
            wall_s=0.003,
            shard=1,
        )
        back = wire.decode_plan(
            roundtrip(wire.encode_plan(plan)), wire.uid_index([a, b])
        )
        # decisions are re-bound to the SAME live objects, not copies
        assert back.result.decisions[0].action is a
        assert back.result.decisions[1].action is b
        assert back.result.decisions[1].units == {"r": 4}
        assert back.result.objective == 7.5 and back.result.evicted == 1
        assert (back.part, back.held, back.shard, back.planned) == ("r", 2, 1, True)

    def test_unknown_uid_rejected(self):
        a = Action(name="a", cost={"r": fixed("r")}, trajectory_id="t0")
        plan = PartitionPlan("r", result=ScheduleResult([Decision(a, {"r": 1})]))
        payload = wire.encode_plan(plan)
        with pytest.raises(wire.WireError, match="unknown action uid"):
            wire.decode_plan(payload, {})

    def test_quota_hold_plan(self):
        plan = PartitionPlan("r", result=None, held=3)
        back = wire.decode_plan(roundtrip(wire.encode_plan(plan)), {})
        assert back.result is None and back.held == 3 and back.planned


# ---------------------------------------------------------------------------
# TaskShard (sub-queue migration payload)
# ---------------------------------------------------------------------------


class TestTaskShardCodec:
    def test_round_trip_preserves_tags_and_order(self):
        q = PartitionQueue(fair=True, cost_of=lambda a: 2.0)
        actions = [
            Action(name=f"x{i}", cost={"r": fixed("r")}, task_id="mover",
                   trajectory_id=f"t{i}")
            for i in range(4)
        ]
        for a in actions:
            q.push(a)
        shard = q.detach_task("mover")
        back = wire.decode_task_shard(roundtrip(wire.encode_task_shard(shard)))
        assert back.task_id == "mover"
        assert back.vtime == shard.vtime
        assert back.finish_tag == shard.finish_tag
        assert [k for k, _ in back.entries] == [k for k, _ in shard.entries]
        assert [a.uid for _, a in back.entries] == [a.uid for a in actions]
        # and it merges into a replica queue like the original would
        replica = PartitionQueue(fair=True)
        replica.merge_shard(back)
        assert [a.uid for a in replica.ordered()] == [a.uid for a in actions]
        assert replica.vtime >= shard.vtime


# ---------------------------------------------------------------------------
# manager snapshots
# ---------------------------------------------------------------------------


def _loaded_managers():
    loop = EventLoop()
    ms = {
        "pool": ResourceManager("pool", 16),
        "cpu": CpuManager(
            [CpuNodeSpec("n0", cores=16, memory_gb=64.0),
             CpuNodeSpec("n1", cores=8, numa_nodes=1, memory_gb=32.0)]
        ),
        "gpu": GpuManager([GpuNodeSpec("g0")], [ServiceSpec("rm0", 40.0)]),
        "api": BasicResourceManager(
            ApiResourceSpec("api", mode="quota", quota=6, period_s=9.0), loop.clock
        ),
    }
    # dirty every manager so the snapshots carry non-trivial state
    ms["pool"].note_allocated("t", 3)
    ms["pool"]._in_use = 3
    ms["cpu"].try_allocate(
        Action(name="c", cost={"cpu": fixed("cpu", 3)}, trajectory_id="tr0",
               metadata={"traj_mem_gb": 8.0}),
        3,
    )
    ms["gpu"].allocators["g0"].allocate(2, ("rm0", 2), 1.5)
    ms["api"].try_allocate(
        Action(name="q", cost={"api": fixed("api")}, trajectory_id="tr1"), 2
    )
    return ms


class TestSnapshotCodec:
    @pytest.mark.parametrize("rtype", ["pool", "cpu", "gpu", "api"])
    def test_round_trip_identity(self, rtype):
        m = _loaded_managers()[rtype]
        enc = wire.encode_snapshot(m)
        back = wire.decode_snapshot(roundtrip(enc))
        # encode(restore(encode(m))) == encode(m): the codec is lossless
        assert wire_equal(wire.encode_snapshot(back), enc)

    @pytest.mark.parametrize("rtype", ["pool", "cpu", "gpu", "api"])
    def test_plan_surface_matches_in_process_snapshot(self, rtype):
        m = _loaded_managers()[rtype]
        snap = m.snapshot()
        back = wire.decode_snapshot(wire.encode_snapshot(m))
        assert back.available == snap.available
        assert back.capacity == snap.capacity
        assert back.task_usage() == snap.task_usage()
        assert back.dp_cache_key([]) == snap.dp_cache_key([])
        probe = Action(
            name="p", cost={rtype: fixed(rtype, 1)}, trajectory_id="fresh",
        )
        cur_a, cur_b = snap.begin_admission(), back.begin_admission()
        assert snap.admit_one(cur_a, probe) == back.admit_one(cur_b, probe)

    def test_cpu_snapshot_binding_stays_remote(self):
        """partition() on a decoded snapshot binds trajectories on the
        decoded copy only — the live manager never hears about it."""
        ms = _loaded_managers()
        back = wire.decode_snapshot(wire.encode_snapshot(ms["cpu"]))
        a = Action(name="x", cost={"cpu": fixed("cpu", 2)}, trajectory_id="tX")
        back.partition([a])
        assert back.node_of("tX") is not None
        assert ms["cpu"].node_of("tX") is None

    def test_quota_snapshot_pins_clock(self):
        """A decoded quota snapshot reads the tokens of the instant it
        was taken — its frozen clock cannot drift mid-plan."""
        ms = _loaded_managers()
        back = wire.decode_snapshot(wire.encode_snapshot(ms["api"]))
        assert back.available == ms["api"].available == 4
        assert back.time_to_next_refill() == pytest.approx(
            ms["api"].time_to_next_refill()
        )

    def test_custom_subclass_uses_family_codec(self):
        class Custom(ResourceManager):
            pass

        m = Custom("x", 4)
        m.note_allocated("t", 1)
        m._in_use = 1
        back = wire.decode_snapshot(wire.encode_snapshot(m))
        assert back.available == 3 and back.task_usage() == {"t": 1}

    def test_unknown_impl_rejected(self):
        p = wire.encode_snapshot(ResourceManager("x", 4))
        p["impl"] = "quantum"
        with pytest.raises(wire.WireError, match="unknown snapshot impl"):
            wire.decode_snapshot(p)

    def test_manager_without_codec_rejected(self):
        class NoWire(ResourceManager):
            wire_impl = None

        with pytest.raises(wire.WireError, match="no wire snapshot impl"):
            wire.encode_snapshot(NoWire("x", 4))


# ---------------------------------------------------------------------------
# policy / fairness config
# ---------------------------------------------------------------------------


class TestPolicyCodec:
    def test_elastic_round_trip(self):
        p = ElasticScheduler(depth=3, candidate_limit=64,
                             estimate_units="dp_avg", cache_dp=True)
        p.eviction_search = "exhaustive"
        p.use_dense = False
        p.dop_floor = 2
        p.fair_share = FairSharePolicy(weights={"a": 2.0}, quota={"a": 0.5})
        back = wire.decode_policy(roundtrip(wire.encode_policy(p)))
        assert isinstance(back, ElasticScheduler)
        for attr in ("depth", "candidate_limit", "estimate_units",
                     "eviction_search", "cache_dp", "use_dense",
                     "dense_backend", "dop_floor", "floor_pressure"):
            assert getattr(back, attr) == getattr(p, attr), attr
        assert back.fair_share.weights == {"a": 2.0}
        assert back.fair_share.quota == {"a": 0.5}

    def test_baseline_policies_round_trip(self):
        back = wire.decode_policy(roundtrip(wire.encode_policy(
            FcfsPolicy(candidate_limit=7))))
        assert isinstance(back, FcfsPolicy) and back.candidate_limit == 7
        back = wire.decode_policy(roundtrip(wire.encode_policy(
            StaticDopPolicy(dop=8, candidate_limit=9))))
        assert isinstance(back, StaticDopPolicy)
        assert back.dop == 8 and back.candidate_limit == 9

    def test_custom_policy_rejected(self):
        class MyPolicy:
            candidate_limit = 4

        with pytest.raises(wire.WireError, match="not wire-serializable"):
            wire.encode_policy(MyPolicy())

    def test_fair_share_none_round_trips(self):
        assert wire.encode_fair_share(None) is None
        assert wire.decode_fair_share(None) is None


# ---------------------------------------------------------------------------
# fingerprints (snapshot-delta suppression)
# ---------------------------------------------------------------------------


class TestFingerprint:
    def test_stable_across_key_order(self):
        assert wire.fingerprint({"a": 1, "b": 2}) == wire.fingerprint(
            {"b": 2, "a": 1}
        )

    def test_state_change_rotates(self):
        m = ResourceManager("r", 8)
        fp0 = wire.fingerprint(wire.encode_snapshot(m))
        m.try_allocate(Action(name="x", cost={"r": fixed("r")},
                              trajectory_id="t"), 2)
        assert wire.fingerprint(wire.encode_snapshot(m)) != fp0


# ---------------------------------------------------------------------------
# the documented worked example must decode against the REAL codecs
# ---------------------------------------------------------------------------

DOC = Path(__file__).resolve().parent.parent / "docs" / "wire-protocol.md"


def _doc_examples():
    """``<!-- wire-example: <name> -->`` fenced JSON blocks from the
    wire-protocol doc, as (name, parsed payload) pairs."""
    text = DOC.read_text()
    out = {}
    for m in re.finditer(
        r"<!--\s*wire-example:\s*(?P<name>[\w-]+)\s*-->\s*```json\n(?P<body>.*?)```",
        text,
        re.DOTALL,
    ):
        out[m.group("name")] = json.loads(m.group("body"))
    return out


class TestDocumentedExample:
    def test_doc_exists_and_has_examples(self):
        examples = _doc_examples()
        assert {"action", "snapshot", "plan-request", "plan-response"} <= set(
            examples
        ), f"wire-protocol.md examples incomplete: {sorted(examples)}"

    def test_documented_action_decodes(self):
        a = wire.decode_action(_doc_examples()["action"])
        assert a.scalable and a.key_resource == "cpu"
        # and re-encoding reproduces the documented payload field-for-field
        assert wire.encode_action(a) == _doc_examples()["action"]

    def test_documented_snapshot_decodes(self):
        m = wire.decode_snapshot(_doc_examples()["snapshot"])
        assert m.available >= 0
        assert wire.encode_snapshot(m) == _doc_examples()["snapshot"]

    def test_documented_round_replays_through_a_real_worker(self):
        """The doc's plan-request example, fed to a real RemoteShardWorker,
        must produce exactly the documented plan-response (modulo the
        measured timing fields)."""
        from repro_torch.core.remote import RemoteShardWorker

        examples = _doc_examples()
        worker = RemoteShardWorker()
        resp = wire.loads(worker.handle(wire.dumps(examples["plan-request"])))
        assert resp["kind"] == "plan_response", resp
        documented = examples["plan-response"]
        for got, want in zip(resp["plans"], documented["plans"], strict=True):
            got = dict(got)
            want = dict(want)
            got.pop("wall_s"), want.pop("wall_s")  # measured, not schema
            assert got == want

    def test_documented_delta_and_ref_rounds_replay(self):
        """The doc's incremental sequence — full request, then snapshot-delta +
        intern-define request, then the all-refs steady-state request — must
        replay through one worker, each round yielding a plan_response, with
        the ref round planning identically to the delta round off pure cached
        state."""
        from repro_torch.core.remote import RemoteShardWorker

        examples = _doc_examples()
        assert {"plan-request-delta", "plan-request-ref"} <= set(examples)
        worker = RemoteShardWorker()
        blobs = []
        resps = []
        for name in ("plan-request", "plan-request-delta", "plan-request-ref"):
            blob = wire.encode_frame(examples[name], codec="json")
            blobs.append(blob)
            resp = wire.decode_frame(worker.handle_bytes(blob))
            assert resp["kind"] == "plan_response", (name, resp)
            resps.append(resp)
        delta_plan, ref_plan = resps[1]["plans"], resps[2]["plans"]
        assert [p["result"]["decisions"] for p in ref_plan] == [
            p["result"]["decisions"] for p in delta_plan
        ]
        # the steady-state request is a fraction of the priming requests
        assert len(blobs[2]) < len(blobs[0]) / 2
        assert len(blobs[2]) < len(blobs[1]) / 2


class TestDocumentedPatchDefine:
    def test_documented_patch_define_resolves(self):
        """The doc's patch-define node names the real fingerprints: its
        ``base`` is the documented action's fingerprint, and resolving
        the patch through a real worker yields an action whose
        re-encoded fingerprint is exactly the node's ``idef``."""
        from repro_torch.core.remote import RemoteShardWorker

        examples = _doc_examples()
        assert "patch-define" in examples
        node = examples["patch-define"]
        act = examples["action"]
        assert node["base"] == wire.fingerprint(act)

        worker = RemoteShardWorker()
        missing = []
        base = worker._resolve_action(wire.intern_def(node["base"], act), missing)
        patched = worker._resolve_action(node, missing)
        assert missing == []
        assert patched is not base
        assert wire.fingerprint(wire.encode_action(patched)) == node["idef"]
        assert patched.state.value == "running" and patched.attempts == 1


class TestDocumentedCommitExample:
    """The two-phase commit section's worked payloads must replay
    through a real worker: the documented commit block fused onto the
    documented plan-request yields exactly the documented
    plan_commit_response (modulo measured timings), and the documented
    commit_decide abort restores the stash and revokes the lease."""

    REQUIRED = {
        "commit-block",
        "plan-commit-response",
        "commit-decide",
        "commit-decide-response",
    }

    def test_doc_has_commit_examples(self):
        examples = _doc_examples()
        assert self.REQUIRED <= set(examples), sorted(examples)

    @staticmethod
    def _fused_prepare(examples):
        return {
            **examples["plan-request"],
            "kind": "plan_commit",
            "commit": examples["commit-block"],
        }

    def test_documented_lease_round_trips(self):
        node = _doc_examples()["commit-block"]["leases"][0]
        assert wire.decode_lease(node) == ("pool0", 0, True, None)
        assert wire.encode_lease("pool0", 0, fresh=True) == node

    def test_documented_outcome_round_trips(self):
        node = _doc_examples()["plan-commit-response"]["passes"][0]["outcomes"][0]
        part, launched, failed, held = wire.decode_commit_outcome(node)
        assert (part, failed, held) == ("pool0", 0, 0)
        assert wire.encode_commit_outcome(part, launched, failed, held) == node

    def test_documented_prepare_replays_through_a_real_worker(self):
        from repro_torch.core.remote import RemoteShardWorker

        examples = _doc_examples()
        worker = RemoteShardWorker()
        resp = wire.loads(worker.handle(wire.dumps(self._fused_prepare(examples))))
        assert resp["kind"] == "plan_commit_response", resp
        documented = examples["plan-commit-response"]
        # measured timings (and the cache stats block) are not schema
        for d in (resp, documented):
            for key in ("plan_s", "commit_s", "codec_s", "cache"):
                d.pop(key, None)
        for got, want in zip(
            resp["passes"], documented["passes"], strict=True
        ):
            for gp, wp in zip(got["plans"], want["plans"], strict=True):
                gp, wp = dict(gp), dict(wp)
                gp.pop("wall_s"), wp.pop("wall_s")
                assert gp == wp
            assert got["outcomes"] == want["outcomes"]
        # everything else — shard, more, and the post-commit replica
        # fingerprints — must match the doc byte for byte
        resp.pop("passes"), documented.pop("passes")
        assert resp == documented

    def test_documented_decide_aborts_and_revokes(self):
        from repro_torch.core.remote import RemoteShardWorker

        examples = _doc_examples()
        worker = RemoteShardWorker()
        wire.loads(worker.handle(wire.dumps(self._fused_prepare(examples))))
        resp = wire.loads(worker.handle(wire.dumps(examples["commit-decide"])))
        assert resp == examples["commit-decide-response"]
        # the revoked lease is gone: re-asserting epoch 0 (no fresh
        # grant this time) is the documented stale_epoch refusal
        stale = dict(self._fused_prepare(examples))
        stale["commit"] = {
            **examples["commit-block"],
            "leases": [wire.encode_lease("pool0", 0)],
        }
        refusal = wire.loads(worker.handle(wire.dumps(stale)))
        assert refusal["kind"] == "error"
        assert refusal["code"] == "stale_epoch"
        assert refusal["rtypes"] == ["pool0"]
