"""Versioned wire serialization for the distributed round engine.

The plan/commit engine (:mod:`repro_torch.core.shards`) made arrangement
side-effect-free over manager snapshots; this module is what lets those
plans leave the process: plain ``dataclass <-> dict`` codecs — **no
pickle anywhere** — for every object that crosses the plan/commit
boundary:

* :class:`~repro_torch.core.action.Action` (and its nested
  :class:`~repro_torch.core.action.ResourceRequest` /
  :class:`~repro_torch.core.action.Elasticity` models),
* :class:`~repro_torch.core.scheduler.ScheduleResult` /
  :class:`~repro_torch.core.scheduler.Decision` — decisions travel as
  ``(uid, units)`` pairs and are re-bound to the *live* Action objects
  at decode (the commit phase never trusts a remote object graph),
* :class:`~repro_torch.core.shards.PartitionPlan`,
* :class:`~repro_torch.core.fairqueue.TaskShard` (sub-queue migration),
* manager ``snapshot()`` payloads for all four manager families
  (``snapshot_state``/``restore_snapshot`` on the managers; this module
  owns the envelope + the impl registry),
* scheduling-policy and :class:`~repro_torch.core.fairqueue.FairSharePolicy`
  configuration (so a remote worker can construct an equivalent
  policy).

Schema and compatibility rules (see ``docs/wire-protocol.md``):

* every top-level payload is an **envelope**
  ``{"v": WIRE_VERSION, "kind": "<type>", ...fields}``;
* decoders reject a payload whose ``v`` differs from their own
  :data:`WIRE_VERSION` or whose ``kind`` is not the expected one — a
  version bump is a breaking change by definition;
* decoders **ignore unknown fields** (additive evolution within a
  version is compatible); encoders always emit every schema field;
* a malformed payload raises :class:`WireError`, never a bare
  ``KeyError``/``TypeError`` — schema violations are protocol errors.

Doctest — an action survives the round trip identically:

>>> from repro_torch.core.action import Action, fixed
>>> a = Action(name="tool", cost={"cpu": fixed("cpu", 2)},
...            base_duration=1.5, task_id="t0", trajectory_id="tr0")
>>> b = decode_action(encode_action(a))
>>> (b.uid, b.name, b.cost["cpu"].units) == (a.uid, "tool", (2,))
True
>>> encode_action(b) == encode_action(a)
True
"""

from __future__ import annotations

import copy
import hashlib
import json
import math
import struct
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Type

from repro_torch.core.action import (
    Action,
    ActionState,
    AmdahlElasticity,
    Elasticity,
    LinearElasticity,
    ResourceRequest,
    TableElasticity,
)
from repro_torch.core.fairqueue import FairSharePolicy, TaskShard
from repro_torch.core.managers.base import ResourceManager
from repro_torch.core.scheduler import Decision, ScheduleResult

#: Wire protocol version.  Decoders accept exactly this version; any
#: breaking change to a payload schema must bump it.
WIRE_VERSION = 1


class WireError(ValueError):
    """A payload violated the wire schema (wrong version/kind/field)."""


#: Hard ceiling on a single transport frame (either direction).  A
#: length prefix above it is rejected before any allocation — a
#: corrupted or hostile prefix must never make a receiver try to
#: buffer gigabytes.  Generous vs real traffic: the delta protocol
#: keeps steady-state rounds in the tens of KB.
MAX_FRAME_BYTES = 64 << 20


class TransportError(WireError):
    """A transport-level failure moving a frame (not a schema error).

    Carries a machine-readable ``code`` so the round client can treat
    every transport as one failure domain:

    ==================  ====================================================
    code                meaning
    ==================  ====================================================
    ``connect``         could not reach the peer (refused / DNS / timeout)
    ``read_timeout``    peer reachable but no frame within the read timeout
    ``truncated_frame`` peer closed (or died) mid-frame
    ``frame_too_large`` length prefix exceeds :data:`MAX_FRAME_BYTES`
    ``reset``           connection reset / broken pipe / worker died
    ``closed``          this transport was already closed locally
    ==================  ====================================================

    Every code is recovered the same way by
    :class:`~repro_torch.core.remote.RemoteRoundClient`: the worker's
    partitions fall back to inline planning for the round, the
    transport is torn down, and reconnection is retried with bounded
    round-based backoff."""

    def __init__(self, code: str, message: str) -> None:
        super().__init__(message)
        self.code = code


# ---------------------------------------------------------------------------
# envelope helpers
# ---------------------------------------------------------------------------


def envelope(kind: str, body: Dict[str, Any]) -> Dict[str, Any]:
    """Wrap ``body`` in the versioned envelope all top-level payloads use."""
    out = {"v": WIRE_VERSION, "kind": kind}
    out.update(body)
    return out


def expect(payload: Any, kind: str) -> Dict[str, Any]:
    """Validate the envelope of ``payload`` and return it.

    Raises :class:`WireError` on a non-dict payload, a version mismatch,
    or a kind mismatch — the three ways an incompatible peer shows up.
    """
    if not isinstance(payload, dict):
        raise WireError(f"{kind}: payload must be a dict, got {type(payload).__name__}")
    v = payload.get("v")
    if v != WIRE_VERSION:
        raise WireError(f"{kind}: wire version {v!r} != supported {WIRE_VERSION}")
    got = payload.get("kind")
    if got != kind:
        raise WireError(f"expected kind {kind!r}, got {got!r}")
    return payload


def _field(payload: Mapping[str, Any], kind: str, name: str) -> Any:
    try:
        return payload[name]
    except KeyError:
        raise WireError(f"{kind}: missing required field {name!r}") from None


def _canon(obj: Any, out: List[str]) -> None:
    """Append the canonical text of a JSON-able payload to ``out``.

    Canonical form is what makes :func:`fingerprint` a *content* hash
    rather than an encoding hash: dict keys are sorted, ``-0.0``
    collapses to ``0.0``, integral floats hash like the equal int
    (``2.0`` == ``2``), and every NaN maps to one fixed token (NaN
    compares unequal to itself, so repr-based hashing would let two
    equal payloads diverge).  Equal payloads therefore always collide,
    regardless of key order, float spelling, or which side built them.
    """
    if obj is None:
        out.append("n")
    elif obj is True:
        out.append("t")
    elif obj is False:
        out.append("f")
    elif isinstance(obj, int):
        out.append(repr(obj))
    elif isinstance(obj, float):
        if math.isnan(obj):
            out.append("NaN")
        elif obj == 0.0:
            out.append("0")  # -0.0 == 0.0 must collide
        elif math.isinf(obj):
            out.append("Inf" if obj > 0 else "-Inf")
        elif obj.is_integer() and abs(obj) < 2**53:
            out.append(repr(int(obj)))
        else:
            out.append(repr(obj))
    elif isinstance(obj, str):
        # length-prefixed raw text: unambiguous without per-string
        # escaping (json.dumps per leaf dominated fingerprint cost)
        out.append(f"s{len(obj)}:{obj}")
    elif isinstance(obj, (list, tuple)):
        out.append("[")
        for x in obj:
            _canon(x, out)
            out.append(",")
        out.append("]")
    elif isinstance(obj, dict) or isinstance(obj, Mapping):
        out.append("{")
        for k in sorted(obj):
            ks = str(k)
            out.append(f"s{len(ks)}:{ks}")
            out.append(":")
            _canon(obj[k], out)
            out.append(",")
        out.append("}")
    else:
        raise WireError(f"fingerprint: non-JSON-able value {type(obj).__name__}")


def fingerprint(payload: Any) -> str:
    """Stable content hash of a JSON-able payload (delta suppression:
    a sender may replace an unchanged payload with ``{"ref": fp}``).

    Hashes the *canonical form* (see :func:`_canon`): equal payloads
    always produce equal fingerprints even when key order or float
    encoding differ between the two sides."""
    chunks: List[str] = []
    _canon(payload, chunks)
    return hashlib.sha1("".join(chunks).encode()).hexdigest()


def list_fingerprint(member_fps: Sequence[str]) -> str:
    """Order-sensitive digest of a sequence of member fingerprints —
    the identity of an action *list* for cross-round list deltas.  Two
    lists collide exactly when they hold the same members in the same
    order (member fingerprints embed each action's uid, so distinct
    live actions never alias)."""
    return hashlib.sha1("|".join(member_fps).encode()).hexdigest()


def dumps(payload: Any) -> str:
    """Serialize a payload to its wire string (Python-dialect JSON:
    ``NaN``/``Infinity`` literals are legal — unprofiled durations and
    unset timestamps travel as NaN)."""
    return json.dumps(payload, separators=(",", ":"))


def loads(blob: str) -> Any:
    """Parse a wire string produced by :func:`dumps`."""
    try:
        return json.loads(blob)
    except json.JSONDecodeError as e:
        raise WireError(f"malformed wire payload: {e}") from None


# ---------------------------------------------------------------------------
# compact binary framing (codec="binary"; JSON stays the v1 compat path)
# ---------------------------------------------------------------------------

#: First byte of a binary frame.  0xB1 is a UTF-8 *continuation* byte,
#: so no valid JSON text can start with it — :func:`decode_frame` sniffs
#: this one byte to route between the binary codec and the JSON path.
WIRE_MAGIC = 0xB1

#: Wire codec names accepted end to end (Orchestrator ``wire_codec``).
WIRE_CODECS = ("json", "binary")

# value tags of the binary frame body
_T_NULL, _T_FALSE, _T_TRUE = 0x00, 0x01, 0x02
_T_INT, _T_FLOAT, _T_STR = 0x03, 0x04, 0x05
_T_LIST, _T_DICT, _T_SREF = 0x06, 0x07, 0x08
_T_INTS, _T_FLOATS = 0x09, 0x0A
_T_BLOB = 0x0B  # spliced pre-encoded segment (length-prefixed sub-frame)

_F64 = struct.Struct(">d")


class Encoded:
    """A pre-encoded wire segment, splice-ready.

    The encode-memoization layer (remote.RemoteRoundClient) caches the
    *bytes* of sections whose fingerprints it already tracks for delta
    suppression — a full snapshot envelope, an interned action payload,
    the policy config — and assembles request frames by splicing those
    cached segments instead of re-serializing the payload tree.  A
    segment is codec-specific: ``"json"`` holds the exact
    :func:`dumps` text (splicing byte-joins it, so a spliced frame is
    byte-identical to a plain one), ``"binary"`` holds a standalone
    sub-frame body with its *own* string table (frame-level string
    interning is positional, so a segment cannot reuse the enclosing
    frame's table) framed by the :data:`_T_BLOB` tag.  Decoders never
    see the difference: a spliced frame decodes to the identical
    payload tree."""

    __slots__ = ("codec", "blob")

    def __init__(self, codec: str, blob: bytes) -> None:
        self.codec = codec
        self.blob = blob

    def __len__(self) -> int:
        return len(self.blob)


def encode_segment(payload: Any, codec: str = "json") -> Encoded:
    """Pre-encode one payload subtree for frame splicing (see
    :class:`Encoded`)."""
    if codec == "json":
        return Encoded("json", dumps(payload).encode("utf-8"))
    if codec != "binary":
        raise WireError(f"unknown wire codec {codec!r} (have {WIRE_CODECS})")
    out = bytearray()
    _enc_value(payload, out, {})
    return Encoded("binary", bytes(out))


def _uvarint(n: int, out: bytearray) -> None:
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _zz_big(n: int) -> int:  # arbitrary-precision zigzag
    return n << 1 if n >= 0 else ((-n) << 1) - 1


def _enc_value(obj: Any, out: bytearray, strings: Dict[str, int]) -> None:
    """One value of the binary frame.  Strings are interned at frame
    level: the first occurrence travels inline (and registers itself in
    the table, on both sides), every repeat is a table reference — the
    hot dict keys (``uid``, ``state``, ...) are paid for once per frame.
    Homogeneous int/float lists pack as columns (no per-element tags)."""
    if obj is None:
        out.append(_T_NULL)
    elif obj is True:
        out.append(_T_TRUE)
    elif obj is False:
        out.append(_T_FALSE)
    elif isinstance(obj, int):
        out.append(_T_INT)
        _uvarint(_zz_big(obj), out)
    elif isinstance(obj, float):
        out.append(_T_FLOAT)
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        idx = strings.get(obj)
        if idx is not None:
            out.append(_T_SREF)
            _uvarint(idx, out)
        else:
            strings[obj] = len(strings)
            raw = obj.encode("utf-8")
            out.append(_T_STR)
            _uvarint(len(raw), out)
            out += raw
    elif isinstance(obj, Encoded):
        if obj.codec != "binary":
            raise WireError(
                f"binary frame: cannot splice a {obj.codec!r} segment"
            )
        out.append(_T_BLOB)
        _uvarint(len(obj.blob), out)
        out += obj.blob
    elif isinstance(obj, (list, tuple)):
        if obj and all(type(x) is int for x in obj):
            out.append(_T_INTS)
            _uvarint(len(obj), out)
            for x in obj:
                _uvarint(_zz_big(x), out)
        elif obj and all(type(x) is float for x in obj):
            out.append(_T_FLOATS)
            _uvarint(len(obj), out)
            for x in obj:
                out += _F64.pack(x)
        else:
            out.append(_T_LIST)
            _uvarint(len(obj), out)
            for x in obj:
                _enc_value(x, out, strings)
    elif isinstance(obj, dict) or isinstance(obj, Mapping):
        out.append(_T_DICT)
        _uvarint(len(obj), out)
        for k, v in obj.items():
            if not isinstance(k, str):
                raise WireError(f"binary frame: non-str dict key {k!r}")
            _enc_value(k, out, strings)
            _enc_value(v, out, strings)
    else:
        raise WireError(
            f"binary frame: unsupported value type {type(obj).__name__}"
        )


class _FrameReader:
    __slots__ = ("blob", "pos", "strings")

    def __init__(self, blob: bytes, pos: int) -> None:
        self.blob = blob
        self.pos = pos
        self.strings: List[str] = []

    def _uvarint(self) -> int:
        n = shift = 0
        blob, pos = self.blob, self.pos
        try:
            while True:
                b = blob[pos]
                pos += 1
                n |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
        except IndexError:
            raise WireError("binary frame: truncated varint") from None
        self.pos = pos
        return n

    def _unzig(self) -> int:
        n = self._uvarint()
        return (n >> 1) if not n & 1 else -((n + 1) >> 1)

    def value(self) -> Any:
        blob = self.blob
        try:
            tag = blob[self.pos]
        except IndexError:
            raise WireError("binary frame: truncated value") from None
        self.pos += 1
        if tag == _T_NULL:
            return None
        if tag == _T_TRUE:
            return True
        if tag == _T_FALSE:
            return False
        if tag == _T_INT:
            return self._unzig()
        if tag == _T_FLOAT:
            pos = self.pos
            self.pos = pos + 8
            try:
                return _F64.unpack_from(blob, pos)[0]
            except struct.error:
                raise WireError("binary frame: truncated float") from None
        if tag == _T_STR:
            n = self._uvarint()
            pos = self.pos
            self.pos = pos + n
            if self.pos > len(blob):
                raise WireError("binary frame: truncated string")
            s = blob[pos : pos + n].decode("utf-8")
            self.strings.append(s)
            return s
        if tag == _T_SREF:
            idx = self._uvarint()
            try:
                return self.strings[idx]
            except IndexError:
                raise WireError(
                    f"binary frame: string ref {idx} out of range"
                ) from None
        if tag == _T_LIST:
            return [self.value() for _ in range(self._uvarint())]
        if tag == _T_INTS:
            return [self._unzig() for _ in range(self._uvarint())]
        if tag == _T_FLOATS:
            n = self._uvarint()
            pos = self.pos
            self.pos = pos + 8 * n
            try:
                return [
                    _F64.unpack_from(blob, pos + 8 * i)[0] for i in range(n)
                ]
            except struct.error:
                raise WireError("binary frame: truncated float column") from None
        if tag == _T_DICT:
            n = self._uvarint()
            out: Dict[str, Any] = {}
            for _ in range(n):
                k = self.value()
                if not isinstance(k, str):
                    raise WireError("binary frame: non-str dict key")
                out[k] = self.value()
            return out
        if tag == _T_BLOB:
            n = self._uvarint()
            end = self.pos + n
            if end > len(blob):
                raise WireError("binary frame: truncated segment")
            # a segment is a standalone sub-frame: fresh string table
            sub = _FrameReader(blob, self.pos)
            v = sub.value()
            if sub.pos != end:
                raise WireError(
                    f"binary frame: segment length mismatch "
                    f"({sub.pos - self.pos} != {n})"
                )
            self.pos = end
            return v
        raise WireError(f"binary frame: unknown value tag 0x{tag:02x}")


def _json_splice(obj: Any, out: List[bytes]) -> None:
    """Byte-join a payload tree that may contain :class:`Encoded` json
    segments, producing output byte-identical to ``dumps`` over the
    fully materialized tree (same separators, same float spelling, same
    key order) — cached segment bytes are appended verbatim."""
    if isinstance(obj, Encoded):
        if obj.codec != "json":
            raise WireError(f"json frame: cannot splice a {obj.codec!r} segment")
        out.append(obj.blob)
    elif isinstance(obj, dict):
        out.append(b"{")
        first = True
        for k, v in obj.items():
            if not isinstance(k, str):
                raise WireError(f"json splice: non-str dict key {k!r}")
            out.append((b"," if not first else b"") + dumps(k).encode("utf-8") + b":")
            first = False
            _json_splice(v, out)
        out.append(b"}")
    elif isinstance(obj, (list, tuple)):
        out.append(b"[")
        for i, v in enumerate(obj):
            if i:
                out.append(b",")
            _json_splice(v, out)
        out.append(b"]")
    else:
        out.append(dumps(obj).encode("utf-8"))


def encode_frame(payload: Any, codec: str = "json") -> bytes:
    """Serialize a payload to transport bytes in the chosen codec.

    ``"json"`` is the :data:`WIRE_VERSION` = 1 compatibility path
    (UTF-8 :func:`dumps` text, the property-test reference);
    ``"binary"`` is the compact tag/varint frame with frame-level
    string interning and packed int/float columns.  Both decode through
    :func:`decode_frame`, which sniffs the leading byte — binary frames
    start with :data:`WIRE_MAGIC`, which can never begin UTF-8 text.

    A payload may embed :class:`Encoded` segments of the same codec
    (the client's encode-memo cache); the json path splices them by
    byte-join (``dumps`` fails fast on the wrapper type, so segment-free
    frames stay on the C encoder), the binary path by the
    :data:`_T_BLOB` tag.  Either way the frame decodes to the payload
    tree with every segment expanded in place."""
    if codec == "json":
        try:
            return dumps(payload).encode("utf-8")
        except TypeError:
            buf: List[bytes] = []
            _json_splice(payload, buf)
            return b"".join(buf)
    if codec != "binary":
        raise WireError(f"unknown wire codec {codec!r} (have {WIRE_CODECS})")
    out = bytearray([WIRE_MAGIC])
    _enc_value(payload, out, {})
    return bytes(out)


def frame_codec(blob: bytes) -> str:
    """The codec a frame was encoded with (a responder answers in kind)."""
    return "binary" if blob[:1] == bytes([WIRE_MAGIC]) else "json"


def decode_frame(blob: bytes) -> Any:
    """Parse transport bytes from either codec (magic-byte sniffing)."""
    if not blob:
        raise WireError("empty wire frame")
    if blob[0] == WIRE_MAGIC:
        reader = _FrameReader(blob, 1)
        value = reader.value()
        if reader.pos != len(blob):
            raise WireError(
                f"binary frame: {len(blob) - reader.pos} trailing bytes"
            )
        return value
    try:
        text = blob.decode("utf-8")
    except UnicodeDecodeError as e:
        raise WireError(f"malformed wire frame: {e}") from None
    return loads(text)


# ---------------------------------------------------------------------------
# actions (nested: resource requests, elasticity models)
# ---------------------------------------------------------------------------


def encode_request(req: ResourceRequest) -> Dict[str, Any]:
    return {"rtype": req.rtype, "units": list(req.units)}


def decode_request(payload: Mapping[str, Any]) -> ResourceRequest:
    if not isinstance(payload, Mapping):
        raise WireError("resource request must be a dict")
    return ResourceRequest(
        str(_field(payload, "request", "rtype")),
        tuple(int(u) for u in _field(payload, "request", "units")),
    )


def encode_elasticity(e: Elasticity) -> Dict[str, Any]:
    """Elasticity models travel by *name*, never by code: only the three
    library models are wire-legal.  A custom subclass must be registered
    here (and versioned) before it can cross a process boundary."""
    if isinstance(e, AmdahlElasticity):
        return {"model": "amdahl", "serial": e.serial}
    if isinstance(e, TableElasticity):
        return {"model": "table", "knots": [[int(m), float(r)] for m, r in e.table]}
    if isinstance(e, LinearElasticity):
        return {"model": "linear"}
    raise WireError(f"elasticity model {type(e).__name__} is not wire-serializable")


def decode_elasticity(payload: Mapping[str, Any]) -> Elasticity:
    model = _field(payload, "elasticity", "model")
    if model == "amdahl":
        return AmdahlElasticity(serial=float(_field(payload, "elasticity", "serial")))
    if model == "table":
        knots = _field(payload, "elasticity", "knots")
        return TableElasticity(tuple((int(m), float(r)) for m, r in knots))
    if model == "linear":
        return LinearElasticity()
    raise WireError(f"unknown elasticity model {model!r}")


#: JSON-scalar types allowed in wire-transported action metadata.
_SCALARS = (str, int, float, bool, type(None))


def _wire_metadata(meta: Mapping[str, Any]) -> Dict[str, Any]:
    """The JSON-scalar, non-private slice of an action's metadata.

    Planning reads only scalar hints (``traj_mem_gb``); derived caches
    (underscore keys, e.g. the ``_dp_durs`` duration memo) are local and
    recomputed on the far side, and non-scalar payloads never cross."""
    return {
        k: v
        for k, v in meta.items()
        if not k.startswith("_") and isinstance(v, _SCALARS)
    }


def encode_action(a: Action) -> Dict[str, Any]:
    """Encode the schedulable surface of an action.

    Execution payloads (``fn``, ``duration_sampler``) are host-local by
    design and do NOT cross — planning never calls them, and the commit
    phase re-binds decisions to the live Action that still carries them.
    """
    return envelope(
        "action",
        {
            "uid": a.uid,
            "name": a.name,
            "cost": {r: encode_request(req) for r, req in a.cost.items()},
            "key_resource": a.key_resource,
            "elasticity": None if a.elasticity is None else encode_elasticity(a.elasticity),
            "base_duration": a.base_duration,
            "task_id": a.task_id,
            "trajectory_id": a.trajectory_id,
            "weight": a.weight,
            "service": a.service,
            "timeout_s": a.timeout_s,
            "max_retries": a.max_retries,
            "state": a.state.value,
            "submit_time": a.submit_time,
            "start_time": a.start_time,
            "finish_time": a.finish_time,
            "sys_overhead": a.sys_overhead,
            "attempts": a.attempts,
            "metadata": _wire_metadata(a.metadata),
        },
    )


def decode_action(payload: Mapping[str, Any]) -> Action:
    p = expect(payload, "action")
    cost = {
        str(r): decode_request(req) for r, req in _field(p, "action", "cost").items()
    }
    el = p.get("elasticity")
    a = Action(
        name=str(_field(p, "action", "name")),
        cost=cost,
        key_resource=p.get("key_resource"),
        elasticity=None if el is None else decode_elasticity(el),
        base_duration=p.get("base_duration"),
        task_id=str(p.get("task_id", "task0")),
        trajectory_id=str(p.get("trajectory_id", "traj0")),
        weight=p.get("weight"),
        service=p.get("service"),
        timeout_s=p.get("timeout_s"),
        max_retries=int(p.get("max_retries", 0)),
        metadata=dict(p.get("metadata", {})),
        uid=int(_field(p, "action", "uid")),
    )
    try:
        a.state = ActionState(p.get("state", "pending"))
    except ValueError:
        raise WireError(f"action: unknown state {p.get('state')!r}") from None
    a.submit_time = float(p.get("submit_time", math.nan))
    a.start_time = float(p.get("start_time", math.nan))
    a.finish_time = float(p.get("finish_time", math.nan))
    a.sys_overhead = float(p.get("sys_overhead", 0.0))
    a.attempts = int(p.get("attempts", 0))
    return a


#: The mutable action fields a patch-define may carry.  Everything else
#: on the wire surface (uid, cost, elasticity, ids, weights...) is
#: immutable for an action's lifetime, which is exactly why a lifecycle
#: transition can travel as a tiny diff against the previously interned
#: version instead of a full re-define.
PATCH_TIME_FIELDS = ("submit_time", "start_time", "finish_time", "sys_overhead")


def patch_action(base: Action, d: Mapping[str, Any]) -> Action:
    """Materialize a patch-define: a *clone* of the interned ``base``
    action with the diff ``d`` applied.

    The clone is shallow except for ``metadata`` — the interned base is
    shared with every cached list that references it, so it must never
    be mutated in place.  Underscore metadata (the ``_dp_durs`` duration
    memo) carries over: it depends only on immutable fields, exactly the
    reuse argument the intern table itself rests on, and matches the
    serial loop where a live action's memo survives its lifecycle
    transitions.  ``d["metadata"]``, when present, replaces the whole
    wire-visible scalar slice (the client re-sends it on any change)."""
    a = copy.copy(base)
    a.metadata = dict(base.metadata)
    md = d.get("metadata")
    if md is not None:
        kept = {k: v for k, v in a.metadata.items() if k.startswith("_")}
        kept.update(md)
        a.metadata = kept
    st = d.get("state")
    if st is not None:
        try:
            a.state = ActionState(st)
        except ValueError:
            raise WireError(f"action patch: unknown state {st!r}") from None
    if "attempts" in d:
        a.attempts = int(d["attempts"])
    for f in PATCH_TIME_FIELDS:
        if f in d:
            setattr(a, f, float(d[f]))
    return a


# ---------------------------------------------------------------------------
# plans (decisions travel as uid references, re-bound at decode)
# ---------------------------------------------------------------------------


def encode_decision(d: Decision) -> Dict[str, Any]:
    return {"uid": d.action.uid, "units": {r: int(u) for r, u in d.units.items()}}


def encode_schedule_result(r: ScheduleResult) -> Dict[str, Any]:
    return {
        "decisions": [encode_decision(d) for d in r.decisions],
        "objective": r.objective,
        "evicted": r.evicted,
    }


def decode_schedule_result(
    payload: Mapping[str, Any], by_uid: Mapping[int, Action]
) -> ScheduleResult:
    decisions: List[Decision] = []
    for d in _field(payload, "schedule_result", "decisions"):
        uid = int(_field(d, "decision", "uid"))
        action = by_uid.get(uid)
        if action is None:
            raise WireError(f"decision references unknown action uid {uid}")
        decisions.append(
            Decision(action, {str(r): int(u) for r, u in d.get("units", {}).items()})
        )
    return ScheduleResult(
        decisions=decisions,
        objective=float(payload.get("objective", 0.0)),
        evicted=int(payload.get("evicted", 0)),
    )


def encode_plan(plan: "Any") -> Dict[str, Any]:
    """Encode a :class:`~repro_torch.core.shards.PartitionPlan` (imported by
    duck type to keep this module cycle-free with shards.py)."""
    return envelope(
        "partition_plan",
        {
            "part": plan.part,
            "held": plan.held,
            "wall_s": plan.wall_s,
            "shard": plan.shard,
            "planned": plan.planned,
            "result": (
                None if plan.result is None else encode_schedule_result(plan.result)
            ),
        },
    )


def decode_plan(payload: Mapping[str, Any], by_uid: Mapping[int, Action]) -> "Any":
    from repro_torch.core.shards import PartitionPlan

    p = expect(payload, "partition_plan")
    result = p.get("result")
    return PartitionPlan(
        part=str(_field(p, "partition_plan", "part")),
        result=None if result is None else decode_schedule_result(result, by_uid),
        held=int(p.get("held", 0)),
        wall_s=float(p.get("wall_s", 0.0)),
        shard=int(p.get("shard", 0)),
        planned=bool(p.get("planned", True)),
    )


# ---------------------------------------------------------------------------
# worker-owned commit: ownership leases + commit outcomes (additive v1)
# ---------------------------------------------------------------------------


def encode_lease(
    rtype: str, epoch: int, fresh: bool = False, fp: Optional[str] = None
) -> Dict[str, Any]:
    """One epoch-stamped ownership lease over a resource type.

    A lease names the worker that may commit against the authoritative
    replica of ``rtype``.  ``epoch`` increments on every ownership
    change (grant, revocation, fence, adoption after a worker loss) —
    a worker presented with an epoch it does not hold must refuse with
    a typed ``stale_epoch`` error before mutating anything.  ``fresh``
    marks a (re-)grant: the worker adopts the epoch instead of
    asserting it (the authoritative state travels in the same frame
    through the ordinary snapshot rail).  ``fp`` optionally pins the
    snapshot fingerprint the replica must match under this lease."""
    body: Dict[str, Any] = {"rtype": str(rtype), "epoch": int(epoch)}
    if fresh:
        body["fresh"] = True
    if fp is not None:
        body["fp"] = fp
    return body


def decode_lease(payload: Mapping[str, Any]) -> Tuple[str, int, bool, Optional[str]]:
    """Inverse of :func:`encode_lease` →  (rtype, epoch, fresh, fp)."""
    return (
        str(_field(payload, "lease", "rtype")),
        int(_field(payload, "lease", "epoch")),
        bool(payload.get("fresh", False)),
        payload.get("fp"),
    )


def encode_commit_outcome(
    part: str,
    launched: Sequence[Tuple[int, Mapping[str, int]]],
    failed: int,
    held: int,
) -> Dict[str, Any]:
    """One partition's committed outcome inside a ``plan_commit_response``
    pass: which intents launched (uid + the granted unit vector — the
    grant may differ from the planned decision after the quota clamp),
    how many were refused by the committing replicas (conflicts), and
    how many the quota gate held."""
    return {
        "part": str(part),
        "launched": [[int(uid), {r: int(u) for r, u in units.items()}]
                     for uid, units in launched],
        "failed": int(failed),
        "held": int(held),
    }


def decode_commit_outcome(
    payload: Mapping[str, Any],
) -> Tuple[str, List[Tuple[int, Dict[str, int]]], int, int]:
    """Inverse of :func:`encode_commit_outcome` →
    (part, launched, failed, held)."""
    launched = [
        (int(uid), {str(r): int(u) for r, u in units.items()})
        for uid, units in payload.get("launched", [])
    ]
    return (
        str(_field(payload, "commit_outcome", "part")),
        launched,
        int(payload.get("failed", 0)),
        int(payload.get("held", 0)),
    )


# ---------------------------------------------------------------------------
# sub-queue migration: TaskShard
# ---------------------------------------------------------------------------


def encode_task_shard(shard: TaskShard) -> Dict[str, Any]:
    """A detached WFQ sub-queue in transit between partition replicas.

    Entries keep their original ``(vstart, seq)`` tags — the whole point
    of the detach/merge seam is that tags are self-contained, so the
    receiving replica only needs a monotone clock sync to drain fairly.
    """
    return envelope(
        "task_shard",
        {
            "task_id": shard.task_id,
            "finish_tag": shard.finish_tag,
            "vtime": shard.vtime,
            "entries": [
                {"key": [key[0], key[1]], "action": encode_action(a)}
                for key, a in shard.entries
            ],
        },
    )


def decode_task_shard(payload: Mapping[str, Any]) -> TaskShard:
    p = expect(payload, "task_shard")
    entries: List[Tuple[Tuple[float, int], Action]] = []
    for e in _field(p, "task_shard", "entries"):
        key = _field(e, "task_shard entry", "key")
        if not isinstance(key, (list, tuple)) or len(key) != 2:
            raise WireError(f"task_shard: malformed tag {key!r}")
        entries.append(
            ((float(key[0]), int(key[1])), decode_action(_field(e, "task_shard entry", "action")))
        )
    return TaskShard(
        task_id=str(_field(p, "task_shard", "task_id")),
        entries=entries,
        finish_tag=float(p.get("finish_tag", 0.0)),
        vtime=float(p.get("vtime", 0.0)),
    )


# ---------------------------------------------------------------------------
# manager snapshots
# ---------------------------------------------------------------------------

#: Wire-impl registry: payload ``impl`` tag -> manager class that can
#: rebuild a plan-capable snapshot from the state dict.  Populated
#: lazily to avoid importing every manager at module load.
_SNAPSHOT_IMPLS: Optional[Dict[str, Type[ResourceManager]]] = None


def _snapshot_impls() -> Dict[str, Type[ResourceManager]]:
    global _SNAPSHOT_IMPLS
    if _SNAPSHOT_IMPLS is None:
        from repro_torch.core.managers.basic import BasicResourceManager
        from repro_torch.core.managers.cpu import CpuManager
        from repro_torch.core.managers.gpu import GpuManager

        _SNAPSHOT_IMPLS = {
            ResourceManager.wire_impl: ResourceManager,
            CpuManager.wire_impl: CpuManager,
            GpuManager.wire_impl: GpuManager,
            BasicResourceManager.wire_impl: BasicResourceManager,
        }
    return _SNAPSHOT_IMPLS


def encode_snapshot(manager: ResourceManager) -> Dict[str, Any]:
    """Serialize a manager's plan-phase free state.

    Dispatches on the manager's ``wire_impl`` tag; a custom subclass
    inherits its family's codec, which round-trips exactly the plan
    surface (:meth:`ResourceManager.snapshot` contract) — overridden
    placement behaviour stays host-side, where placement happens.
    """
    impl = getattr(manager, "wire_impl", None)
    if impl not in _snapshot_impls():
        raise WireError(
            f"manager {type(manager).__name__} has no wire snapshot impl"
        )
    return envelope(
        "snapshot",
        {"rtype": manager.rtype, "impl": impl, "state": manager.snapshot_state()},
    )


def decode_snapshot(payload: Mapping[str, Any]) -> ResourceManager:
    """Rebuild a plan-capable manager snapshot from its wire payload.

    The returned object supports the plan surface only (the same
    contract as :meth:`ResourceManager.snapshot`); calling placement on
    it is a programming error, exactly as for in-process snapshots.
    """
    p = expect(payload, "snapshot")
    impl = _field(p, "snapshot", "impl")
    cls = _snapshot_impls().get(impl)
    if cls is None:
        raise WireError(f"unknown snapshot impl {impl!r}")
    return cls.restore_snapshot(_field(p, "snapshot", "state"))


# ---------------------------------------------------------------------------
# structural snapshot deltas (wire cost proportional to what changed)
# ---------------------------------------------------------------------------


def encode_snapshot_delta(
    manager: ResourceManager,
    prev_state: Mapping[str, Any],
    cur_state: Mapping[str, Any],
    base_fp: str,
    cur_fp: str,
) -> Dict[str, Any]:
    """Delta envelope: the structural diff ``prev_state -> cur_state``
    for one manager, dispatched to the manager family's
    ``snapshot_delta`` twin.  ``base`` fingerprints the full snapshot
    payload the receiver must already hold; ``fp`` fingerprints the full
    payload the delta must reconstruct — the receiver verifies it, and a
    mismatch (stale or corrupted base) falls back to a full snapshot via
    the typed-error path, never a silently wrong plan."""
    impl = getattr(manager, "wire_impl", None)
    cls = _snapshot_impls().get(impl)
    if cls is None:
        raise WireError(f"manager {type(manager).__name__} has no wire snapshot impl")
    return envelope(
        "snapshot_delta",
        {
            "rtype": manager.rtype,
            "impl": impl,
            "base": base_fp,
            "fp": cur_fp,
            "delta": cls.snapshot_delta(prev_state, cur_state),
        },
    )


def apply_snapshot_delta(
    payload: Mapping[str, Any], base_snapshot: Mapping[str, Any]
) -> Dict[str, Any]:
    """Reconstruct the full ``snapshot`` envelope a delta describes.

    ``base_snapshot`` is the cached full snapshot envelope whose
    fingerprint the sender named in ``base`` (the caller checks that
    before calling).  The reconstruction is fingerprint-verified against
    the delta's ``fp`` — apply never returns a state the sender did not
    hash, so a buggy diff can only fail loudly."""
    p = expect(payload, "snapshot_delta")
    impl = _field(p, "snapshot_delta", "impl")
    cls = _snapshot_impls().get(impl)
    if cls is None:
        raise WireError(f"unknown snapshot impl {impl!r}")
    state = cls.apply_delta(
        _field(base_snapshot, "snapshot", "state"),
        _field(p, "snapshot_delta", "delta"),
    )
    snap = envelope(
        "snapshot",
        {"rtype": str(_field(p, "snapshot_delta", "rtype")), "impl": impl,
         "state": state},
    )
    if fingerprint(snap) != _field(p, "snapshot_delta", "fp"):
        raise WireError(
            f"snapshot delta for {p['rtype']!r} reconstructed a state whose "
            "fingerprint does not match the sender's"
        )
    return snap


# ---------------------------------------------------------------------------
# cross-round payload interning (actions and other repeated payloads)
# ---------------------------------------------------------------------------


def intern_def(fp: str, payload: Any, nbytes: Optional[int] = None) -> Dict[str, Any]:
    """First wire appearance of an interned payload: define-and-use.
    ``fp`` is the canonical fingerprint of the *fully resolved* payload;
    the receiver stores ``payload`` under it and every later round may
    say ``{"iref": fp}`` instead.  ``n`` carries the sender's byte
    accounting so both sides' LRU budgets see identical sizes (the
    receiver falls back to measuring when absent)."""
    out: Dict[str, Any] = {"idef": fp, "val": payload}
    if nbytes is not None:
        out["n"] = int(nbytes)
    return out


def intern_ref(fp: str) -> Dict[str, str]:
    """Reference to a payload the receiver's intern table already holds."""
    return {"iref": fp}


def intern_patch(
    fp: str, base_fp: str, d: Dict[str, Any], nbytes: Optional[int] = None
) -> Dict[str, Any]:
    """Patch-define: intern ``fp`` as the ``base_fp`` payload the
    receiver already holds, with the mutable-field diff ``d`` applied
    (see :func:`patch_action`).  An action's lifecycle transition
    (queued → running, a retry bump) then travels as a handful of
    changed fields instead of a full re-define.  A receiver missing
    ``base_fp`` treats it exactly like a missed ``iref`` — collected
    into the atomic ``stale_intern`` error — and the sender's recovery
    full re-send needs no new machinery."""
    out: Dict[str, Any] = {"idef": fp, "base": base_fp, "d": d}
    if nbytes is not None:
        out["n"] = int(nbytes)
    return out


def resolve_interned(node: Any, table: "LruBytes", missing: List[str]) -> Any:
    """Resolve ``idef``/``iref`` wrappers (recursively) against an
    intern table.  Definitions are stored and unwrapped; references are
    looked up — a miss collects the fingerprint into ``missing`` (and
    yields None) so the caller can answer with one typed ``stale_intern``
    error naming every payload it needs re-sent."""
    if isinstance(node, dict):
        if "iref" in node and len(node) == 1:
            hit = table.get(node["iref"])
            if hit is None:
                missing.append(str(node["iref"]))
            return hit
        if "idef" in node and "val" in node:
            val = resolve_interned(node["val"], table, missing)
            nbytes = node.get("n") or payload_nbytes(val)
            table.put(str(node["idef"]), val, int(nbytes))
            return val
    return node


def payload_nbytes(payload: Any) -> int:
    """Approximate in-memory wire size of a payload (byte-budget LRU
    accounting).  JSON text length is a stable, codec-independent proxy;
    exactness is not needed — the budget bounds growth, it does not
    meter allocations."""
    try:
        return len(json.dumps(payload, separators=(",", ":")))
    except (TypeError, ValueError):
        return 256


class LruBytes:
    """A byte-budget LRU map (worker intern table / snapshot cache, and
    the client's mirror of each worker's table).

    Eviction is deterministic — strict least-recently-*touched* order
    with an exact running byte total — so a client holding a same-budget
    mirror, touching keys in the same order the worker does, predicts
    the worker's evictions exactly.  A divergence (worker restart) is
    not silent: the worker answers a missed ref with a typed error and
    the client re-sends, so the mirror is an optimization, never a
    correctness dependency."""

    def __init__(self, budget_bytes: int = 8 << 20) -> None:
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
        self.budget = int(budget_bytes)
        self._items: Dict[str, Tuple[Any, int]] = {}  # insertion = LRU order
        self._nbytes = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: str) -> bool:
        return key in self._items

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def get(self, key: str) -> Any:
        """Value for ``key`` (refreshing its recency), or None."""
        item = self._items.pop(key, None)
        if item is None:
            return None
        self._items[key] = item  # re-append = most recent
        return item[0]

    def put(self, key: str, value: Any, nbytes: int) -> None:
        old = self._items.pop(key, None)
        if old is not None:
            self._nbytes -= old[1]
        self._items[key] = (value, int(nbytes))
        self._nbytes += int(nbytes)
        # evict least-recently-touched until under budget; a single
        # over-budget entry is kept (the table must stay usable)
        while self._nbytes > self.budget and len(self._items) > 1:
            oldest = next(iter(self._items))
            _, freed = self._items.pop(oldest)
            self._nbytes -= freed
            self.evictions += 1

    def pop(self, key: str) -> None:
        item = self._items.pop(key, None)
        if item is not None:
            self._nbytes -= item[1]

    def clear(self) -> None:
        self._items.clear()
        self._nbytes = 0


# ---------------------------------------------------------------------------
# policy configuration (so a remote worker builds an equivalent policy)
# ---------------------------------------------------------------------------


def encode_fair_share(fs: Optional[FairSharePolicy]) -> Optional[Dict[str, Any]]:
    if fs is None:
        return None
    return {
        "weights": dict(fs.weights),
        "default_weight": fs.default_weight,
        "quota": dict(fs.quota),
        "preempt_scalable": fs.preempt_scalable,
        "share_slack": fs.share_slack,
    }


def decode_fair_share(payload: Optional[Mapping[str, Any]]) -> Optional[FairSharePolicy]:
    if payload is None:
        return None
    return FairSharePolicy(
        weights={str(k): float(v) for k, v in payload.get("weights", {}).items()},
        default_weight=float(payload.get("default_weight", 1.0)),
        quota={str(k): float(v) for k, v in payload.get("quota", {}).items()},
        preempt_scalable=bool(payload.get("preempt_scalable", True)),
        share_slack=float(payload.get("share_slack", 0.1)),
    )


def encode_policy(policy: Any) -> Dict[str, Any]:
    """Policy config by *name + knobs* — code never crosses the wire.

    Only the library policies are wire-legal; a custom policy must be
    registered here before the remote plan phase can run it.
    """
    from repro_torch.core.baselines import FcfsPolicy, StaticDopPolicy
    from repro_torch.core.scheduler import ElasticScheduler

    if isinstance(policy, ElasticScheduler):
        return envelope(
            "policy",
            {
                "type": "elastic",
                "depth": policy.depth,
                "candidate_limit": policy.candidate_limit,
                "estimate_units": policy.estimate_units,
                "eviction_search": policy.eviction_search,
                "cache_dp": policy.cache_dp,
                "use_dense": policy.use_dense,
                "dense_backend": policy.dense_backend,
                "dop_floor": policy.dop_floor,
                "floor_pressure": policy.floor_pressure,
                # the policy's OWN fairness knobs (may be set even when
                # the orchestrator runs plain FCFS queues)
                "fair_share": encode_fair_share(policy.fair_share),
            },
        )
    if isinstance(policy, StaticDopPolicy):  # subclass of Fcfs — test first
        return envelope(
            "policy",
            {"type": "static_dop", "dop": policy.dop,
             "candidate_limit": policy.candidate_limit},
        )
    if isinstance(policy, FcfsPolicy):
        return envelope(
            "policy", {"type": "fcfs", "candidate_limit": policy.candidate_limit}
        )
    raise WireError(f"policy {type(policy).__name__} is not wire-serializable")


def decode_policy(payload: Mapping[str, Any]) -> Any:
    from repro_torch.core.baselines import FcfsPolicy, StaticDopPolicy
    from repro_torch.core.scheduler import ElasticScheduler

    p = expect(payload, "policy")
    ptype = _field(p, "policy", "type")
    if ptype == "elastic":
        policy = ElasticScheduler(
            depth=int(p.get("depth", 2)),
            candidate_limit=int(p.get("candidate_limit", 128)),
            estimate_units=str(p.get("estimate_units", "min")),
            cache_dp=p.get("cache_dp"),
        )
        policy.eviction_search = str(p.get("eviction_search", "greedy"))
        policy.use_dense = bool(p.get("use_dense", True))
        policy.dense_backend = p.get("dense_backend")
        policy.dop_floor = p.get("dop_floor")
        fp = p.get("floor_pressure", math.inf)
        policy.floor_pressure = math.inf if fp is None else float(fp)
        policy.fair_share = decode_fair_share(p.get("fair_share"))
        return policy
    if ptype == "static_dop":
        return StaticDopPolicy(
            dop=int(p.get("dop", 4)),
            candidate_limit=int(p.get("candidate_limit", 128)),
        )
    if ptype == "fcfs":
        return FcfsPolicy(candidate_limit=int(p.get("candidate_limit", 128)))
    raise WireError(f"unknown policy type {ptype!r}")


# ---------------------------------------------------------------------------
# convenience: uid index over live actions (commit-side re-binding)
# ---------------------------------------------------------------------------


def uid_index(actions: Sequence[Action]) -> Dict[int, Action]:
    """uid -> live Action map used to re-bind decoded decisions."""
    return {a.uid: a for a in actions}
