"""Deterministic fault injection for the merge pipeline.

Two halves:

1. **Corrupters** — pure functions that damage a binary change (or sync
   message) in a *specific, reproducible* way, so tests can assert the exact
   taxonomy error each damage class produces (errors.py):
   truncation and garbage → ``DecodeError``, bit flips and checksum damage →
   ``ChecksumError``, chunk-type rewrites (checksum kept valid) →
   ``DecodeError``, seq reuse/gaps and fabricated deps → ``CausalityError``
   (or a permanent queue), counter/element floods → ``PackingLimitError``.

2. **Failure points** — a registry of named hooks the farm, engine and sync
   layers consult at their phase boundaries (``fire``). Tests register a
   hook with ``inject`` to make a specific phase raise — e.g. "the device
   dispatch fails whenever doc 3's rows are in the batch" — which is how the
   farm's bisect/quarantine/fallback paths are exercised without a real
   wedged accelerator. With nothing registered, ``fire`` is a dict lookup.

This is the port's own copy of the JAX package's ``testing/faults.py``,
with its own registry: a hook injected here fires in this package's farm,
engine and sync layers only, never in the JAX package's (and the reverse).
It must stay importable on any host: no torch, no tpu imports (the sync
layer, a host-only module, imports ``fire``).
"""
from __future__ import annotations

import contextlib
from hashlib import sha256

from ..columnar import MAGIC_BYTES, encode_change

# ---------------------------------------------------------------------- #
# failure points

_HOOKS: dict[str, list] = {}

#: points consulted by this package's code, for discoverability in tests
POINTS = (
    "farm.decode",           # per doc, before buffers are decoded
    "farm.device_dispatch",  # before the batched device merge and before
                             #   each bisection probe (docs=tuple)
    "engine.apply_batch",    # host driver, before the merge program
    "engine.visible_state",  # host driver, before the visibility program
    "sync.receive_message",  # before a peer message is decoded
    "sync.receive_message_v2",  # before a peer v2 message is decoded
    "session.receive",       # before a session frame is decoded (frame=bytes)
    "chaos.send",            # chaos transport, before a frame enters a link
    "chaos.deliver",         # chaos transport, before a frame leaves a link
    "store.append",          # before a commit frame hits the WAL (doc=int)
    "store.fsync",           # inside the fsync seam, before fdatasync (path=str)
    "store.rotate",          # at each rotation stage (stage="footer"|"rename")
    "store.compact",         # at each compaction stage (stage="write"|"verify"|
                             #   "swap"|"cleanup")
)


def fire(point: str, **context) -> None:
    """Consults every hook registered for `point`. Hooks simulate failures
    by raising; the exception propagates into the caller's fault-handling
    path exactly like an organic one. Near-zero cost when nothing is
    registered (one dict lookup)."""
    hooks = _HOOKS.get(point)
    if hooks:
        for hook in list(hooks):
            hook(**context)


@contextlib.contextmanager
def inject(point: str, hook):
    """Registers `hook` at a failure point for the dynamic extent.

    The hook is called as ``hook(**context)`` with the point's keyword
    context (e.g. ``docs=(...)`` at ``farm.device_dispatch``) and should
    raise to simulate a failure at that point."""
    _HOOKS.setdefault(point, []).append(hook)
    try:
        yield hook
    finally:
        _HOOKS[point].remove(hook)
        if not _HOOKS[point]:
            del _HOOKS[point]


def fail_docs(poisoned, exc_factory=None):
    """Hook for ``farm.device_dispatch``/``engine.apply_batch``: raises
    whenever any of `poisoned` docs is in the dispatched group, simulating
    a device program that a specific document's rows crash."""
    poisoned = set(poisoned)
    make = exc_factory or (lambda hit: RuntimeError(
        f"injected device fault: poisoned docs {sorted(hit)} in batch"
    ))

    def hook(**context):
        docs = context.get("docs")
        hit = poisoned if docs is None else poisoned & set(docs)
        if hit:
            raise make(hit)

    return hook


def fail_always(exc_factory=None):
    """Hook that fails unconditionally (a wedged device / dead peer)."""
    make = exc_factory or (lambda: RuntimeError("injected unconditional fault"))

    def hook(**_context):
        raise make()

    return hook


def fail_at(n: int, exc_factory=None, stage: str | None = None):
    """Hook that fails on its `n`-th firing (1-based), counting only
    firings whose ``stage`` context matches when one is given. The store
    crash-point sweep walks `n` across every durability boundary of a
    workload; the hook's ``fired`` attribute reports how many matching
    firings happened, so the sweep knows when it has walked off the end."""
    make = exc_factory or (lambda: RuntimeError(f"injected fault at firing {n}"))

    def hook(**context):
        if stage is not None and context.get("stage") != stage:
            return
        hook.fired += 1
        if hook.fired == n:
            raise make()

    hook.fired = 0
    return hook


# ---------------------------------------------------------------------- #
# binary corrupters
#
# Container layout (columnar.encode_container): MAGIC(4) | checksum(4) |
# chunk_type(1) | LEB-length | body. The checksum covers everything from
# the chunk-type byte onward.

_HEADER_END = 8  # MAGIC + checksum; the hashed region starts here


def truncated(buffer: bytes, keep: int | None = None) -> bytes:
    """Drops the tail of the buffer (default: keep the first half, but
    always at least the magic bytes so the failure is a short read, not a
    magic-byte mismatch). Decode raises ``DecodeError``."""
    buffer = bytes(buffer)
    if keep is None:
        keep = max(len(buffer) // 2, len(MAGIC_BYTES) + 1)
    return buffer[:keep]


def bit_flipped(buffer: bytes, bit: int = 0) -> bytes:
    """Flips one bit of the chunk body, leaving the stored checksum stale.
    Decode raises ``ChecksumError`` (the checksum covers the body)."""
    buffer = bytearray(buffer)
    index = _HEADER_END + (bit // 8) % max(len(buffer) - _HEADER_END, 1)
    buffer[index] ^= 1 << (bit % 8)
    return bytes(buffer)


def corrupt_checksum(buffer: bytes) -> bytes:
    """Flips one bit of the stored checksum itself. Decode raises
    ``ChecksumError``."""
    buffer = bytearray(buffer)
    buffer[len(MAGIC_BYTES)] ^= 0x01
    return bytes(buffer)


def _rechecksummed(buffer: bytearray) -> bytes:
    """Recomputes and stores the container checksum over the (possibly
    mutated) hashed region, producing a structurally 'valid' container."""
    digest = sha256(bytes(buffer[_HEADER_END:])).digest()
    buffer[len(MAGIC_BYTES):_HEADER_END] = digest[:4]
    return bytes(buffer)


def bad_chunk_type(buffer: bytes, chunk_type: int = 0x7E) -> bytes:
    """Rewrites the chunk-type byte and *recomputes the checksum*, so the
    container verifies but carries an unknown chunk type — the
    checksum-preserving field mutation of the container header. Decode
    raises ``DecodeError`` ('Unexpected chunk type')."""
    buffer = bytearray(buffer)
    buffer[_HEADER_END] = chunk_type
    return _rechecksummed(buffer)


def garbage(length: int = 64, seed: int = 0) -> bytes:
    """Deterministic bytes that are not an Automerge container at all.
    Decode raises ``DecodeError`` (magic-byte mismatch)."""
    out = bytearray()
    state = seed & 0xFFFFFFFF
    while len(out) < length:
        state = (1103515245 * state + 12345) & 0xFFFFFFFF
        out.append((state >> 16) & 0xFF)
    # make sure we never accidentally start with the magic bytes
    if bytes(out[:4]) == MAGIC_BYTES:
        out[0] ^= 0xFF
    return bytes(out[:length])


# ---------------------------------------------------------------------- #
# semantically poisoned (but structurally valid) change factories

def make_change(actor: str, seq: int, start_op: int, deps, ops) -> bytes:
    """A structurally valid change; the building block the poisoned
    factories mutate. deps are sorted for the caller."""
    return encode_change({
        "actor": actor, "seq": seq, "startOp": start_op, "time": 0,
        "deps": sorted(deps), "ops": list(ops),
    })


def set_op(key: str, value, obj: str = "_root", pred=()) -> dict:
    return {"action": "set", "obj": obj, "key": key, "datatype": "uint",
            "value": value, "pred": list(pred)}


def seq_reused(actor: str, seq: int, start_op: int, deps=()) -> bytes:
    """A change re-using an already-committed seq for `actor` (deliver after
    that seq has applied). The gate raises ``CausalityError``
    ('Reuse of sequence number')."""
    return make_change(actor, seq, start_op, deps,
                       [set_op("poison-reuse", seq)])


def seq_skipped(actor: str, seq: int, start_op: int, deps=()) -> bytes:
    """A change whose seq skips ahead of the committed clock (deliver with
    satisfied deps). The gate raises ``CausalityError``
    ('Skipped sequence number')."""
    return make_change(actor, seq, start_op, deps,
                       [set_op("poison-skip", seq)])


def counter_overflow(actor: str, seq: int, max_counter: int, deps=()) -> bytes:
    """A change whose op counter sits at `max_counter` (pass the engine's
    MAX_COUNTER, e.g. ``automerge_tpu_torch.tpu.rga.MAX_COUNTER``): prevalidation
    raises ``PackingLimitError`` ('merge-key packing range')."""
    return make_change(actor, seq, max_counter, deps,
                       [set_op("poison-overflow", 1)])


def insert_flood(actor: str, seq: int, start_op: int, obj: str, n: int,
                 deps=()) -> bytes:
    """`n` consecutive list inserts into `obj`; with ``n`` past the doc's
    remaining MAX_ELEMS budget, prevalidation raises ``PackingLimitError``
    (rank-kernel range)."""
    ops = []
    for _ in range(n):
        ops.append({"action": "set", "obj": obj, "elemId": "_head",
                    "insert": True, "value": "x", "pred": []})
    return make_change(actor, seq, start_op, deps, ops)


#: a dependency hash that can never be satisfied (no change hashes to it)
MISSING_DEP = "00" * 32


def missing_dep(actor: str, seq: int, start_op: int) -> bytes:
    """A change depending on a hash no peer will ever produce — the
    dep-graph analogue of a cycle (neither this change nor anything after
    it for the actor can ever become ready). Deliveries queue forever
    rather than erroring; tests assert the queue stays bounded and healthy
    docs are unaffected."""
    return make_change(actor, seq, start_op, [MISSING_DEP],
                       [set_op("poison-dep", seq)])


#: (name, corrupter(valid_buffer) -> poisoned_buffer, expected error kind)
#: — the byte-level corpus over any structurally valid change
BYTE_CORPUS = (
    ("truncated", truncated, "decode"),
    ("bit_flipped", bit_flipped, "checksum"),
    ("corrupt_checksum", corrupt_checksum, "checksum"),
    ("bad_chunk_type", bad_chunk_type, "decode"),
    ("garbage", lambda _buf: garbage(48), "decode"),
)
