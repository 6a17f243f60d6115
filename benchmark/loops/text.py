"""The ``text`` loop: one farm, the server, and one ``apply_changes`` call
a step that carries a round of both editors' changes for the step's
documents, timed through `cells.Driver._apply` as the ``apply`` loop times
it. After every ``open_every``-th call the driver reads the whole patch
(``get_patch``) of each of the call's documents, as a client that opens
the document does: an open takes window time but is no ``apply_changes``
call, so it counts in ``merged_ops_per_s`` and not in ``apply_p95_ms``.
A traced part of the window also opens the documents of its first call,
so that every trace holds an open (the traced runs' numbers are per
layer only). Each open is named with the driver's span
(``farm.get_patch``).

The loop judges its runs itself (`check`), against ``reference/text.py``:
every patch a call returned, applied to a client's copy of its document,
and every open's insert script must give the reference's visible text,
with the reference's clock, heads and maxOp; every touched document's
whole patch after the window must too; no delivery may be lost. Its
control (`build_control`) is the reference with siblings in ascending id
order in the farm's place. It hands the readers the opens of the window
and the elements ranked while tracing (`readings`)."""
from __future__ import annotations

import pickle
import time

from harness import cells
from harness.check import CheckResult, _order


def farm_count(stream) -> int:
    return 1


def build(cfg, mix, stream, device):
    """The server's farm; no sync."""
    from automerge_tpu_torch import TorchDocFarm

    return [TorchDocFarm(stream.docs, capacity=cfg["capacity"],
                         device=device)], None


def _text_patch(doc, key, edits):
    """A farm patch of `doc` (a reference TextDoc) whose text object
    carries `edits`."""
    obj = doc.text_id()
    props = {} if obj is None else {key: {obj: {
        "objectId": obj, "type": "text", "edits": edits}}}
    return {"maxOp": doc.max_op, "clock": dict(doc.clock),
            "deps": sorted(doc.heads), "pendingChanges": 0,
            "diffs": {"objectId": "_root", "type": "map", "props": props}}


def _script(seq):
    return [{"action": "insert", "index": i, "elemId": e, "opId": e,
             "value": {"type": "value", "value": v}}
            for i, (e, v) in enumerate(seq)]


class ControlResult(list):
    quarantined: dict = {}


class ControlFarm:
    """The reference with the broken guarantee (siblings in ascending id
    order) in a farm's interface: a call's patch removes the client's
    whole text and inserts it again."""

    def __init__(self, stream, ref_mod, key):
        self.stream, self.ref_mod, self.key = stream, ref_mod, key
        self.by_bytes = {data: i for i, data in enumerate(
            stream.changes.data)}
        self.docs = [ref_mod.TextDoc(ascending=True)
                     for _ in range(stream.docs)]
        self.shown = [0] * stream.docs

    def apply_changes(self, per_doc_buffers):
        out = ControlResult()
        for d, bufs in enumerate(per_doc_buffers):
            if not bufs:
                out.append(None)
                continue
            doc = self.docs[d]
            for data in bufs:
                self.ref_mod.commit(doc, self.stream.changes,
                                    self.by_bytes[data])
            seq = doc.sequence()
            edits = ([{"action": "remove", "index": 0,
                       "count": self.shown[d]}] if self.shown[d] else [])
            self.shown[d] = len(seq)
            out.append(_text_patch(doc, self.key, edits + _script(seq)))
        return out

    def get_patch(self, d):
        doc = self.docs[d]
        return _text_patch(doc, self.key, _script(doc.sequence()))


def build_control(cfg, mix, stream, ref_mod):
    return [ControlFarm(stream, ref_mod, cfg["key"])], None


class Driver(cells.Driver):
    def __init__(self, stream, mix, farms, syncs=None, device="cuda"):
        super().__init__(stream, mix, farms, syncs, device)
        self.every = mix["open_every"]
        self.calls = 0
        self.opens: list[bytes] = []  # pickled (records before it, doc,
        #                               clock, heads, maxOp, pending, props)
        self.window_opens = 0
        self.traced_elems = 0         # elements the traced opens ranked
        self.was_tracing = False
        ch = stream.changes
        self.inserts = [kinds.count("i") for kinds in ch.kinds]
        self.elems = [0] * stream.docs  # elements committed per document

    def run_step(self, step) -> None:
        idxs = step[0][1]
        if self.in_window:
            self.made.extend(idxs)
        self._apply(0, idxs, delivered=True)
        ch = self.stream.changes
        for i in idxs:
            self.elems[ch.doc[i]] += self.inserts[i]
        self.calls += 1
        first_traced = self.tracing and not self.was_tracing
        self.was_tracing = self.tracing
        if self.calls % self.every == 0 or first_traced:
            for d in sorted({ch.doc[i] for i in idxs}):
                self._open(d)

    def _open(self, d) -> None:
        t0 = time.perf_counter()
        with self.span("farm.get_patch"):
            patch = self.farms[0].get_patch(d)
            cells.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.opens.append(pickle.dumps((
            len(self.records), d, dict(patch["clock"]), list(patch["deps"]),
            patch["maxOp"], patch["pendingChanges"],
            patch["diffs"]["props"]), pickle.HIGHEST_PROTOCOL))
        if self.in_window:
            self.window_opens += 1
            self.program_s += dt
        if self.tracing:
            self.traced_elems += self.elems[d]

    def readings(self):
        return {"opens": self.window_opens,
                "traced_elems": self.traced_elems}


ControlDriver = Driver


def _edits(props, key, obj):
    """The edits of text object `obj` under root `key` in a patch's
    props (none where the patch does not list it)."""
    entry = props.get(key, {})
    extra = sorted(set(entry) - {obj})
    if extra:
        raise ValueError(f"{key!r} lists other objects {extra}")
    sub = entry.get(obj)
    return [] if sub is None else sub.get("edits", [])


def _problems(ref_mod, doc, key, clock, heads, max_op, pending, props,
              copy):
    """What is wrong with a patch of `doc` (a reference TextDoc) that
    turns the client's `copy` (changed in place) into its text."""
    bad = []
    if clock != doc.clock:
        bad.append("clock differs")
    if sorted(heads) != sorted(doc.heads):
        bad.append("heads differ")
    if max_op != doc.max_op:
        bad.append(f"maxOp {max_op}, want {doc.max_op}")
    if pending:
        bad.append(f"{pending} changes pending")
    try:
        ref_mod.apply_edits(copy, _edits(props, key, doc.text_id()))
    except (ValueError, IndexError, KeyError, TypeError) as exc:
        bad.append(f"edits do not apply: {exc}")
        return bad
    want = doc.sequence()
    if copy != want:
        at = next((k for k, (a, b) in enumerate(zip(copy, want)) if a != b),
                  min(len(copy), len(want)))
        bad.append(f"text differs from element {at} ({len(copy)} "
                   f"elements, want {len(want)})")
    return bad


def check(ref_mod, stream, driver, finals):
    """The text loop's output check (the four numbers of
    ``harness/check.py``, each with the limit 0):

    - ``patch_mismatches``: calls' patches whose edits, applied to the
      client's copy of the document, do not give the reference's visible
      text, (elemId, value) in order, after the changes delivered so far,
      or whose clock, heads or maxOp are not the reference's, or that
      leave a change pending; and opens whose insert script does not give
      it;
    - ``state_mismatches``: touched documents whose whole patch after the
      window differs from the reference's;
    - ``failed_changes``: changes of the window quarantined, or missing
      from a document's clock after the window;
    - ``unquiesced_epochs``: 0 (no sync).
    """
    ch = stream.changes
    key = ch.text_key
    index = ch.by_author()
    res = CheckResult()
    docs, copies = {}, {}
    opens = [pickle.loads(blob) for blob in driver.opens]
    at = 0
    for k, snap in enumerate(driver.records, 1):
        doc = docs.setdefault(snap.doc, ref_mod.TextDoc())
        for i in _order(ch, snap.delivered or ()):
            ref_mod.commit(doc, ch, i)
        res.patches += 1
        bad = _problems(ref_mod, doc, key, snap.clock, snap.deps,
                        snap.max_op, snap.pending, snap.props,
                        copies.setdefault(snap.doc, []))
        if bad:
            res.patch_mismatches += 1
            res.note(f"patch {k} doc {snap.doc}: " + "; ".join(bad[:3]))
        while at < len(opens) and opens[at][0] == k:
            _, d, clock, heads, max_op, pending, props = opens[at]
            at += 1
            res.patches += 1
            bad = _problems(ref_mod, docs[d], key, clock, heads, max_op,
                            pending, props, [])
            if bad:
                res.patch_mismatches += 1
                res.note(f"open after patch {k} doc {d}: "
                         + "; ".join(bad[:3]))

    lost = {i for _, _, idxs in driver.quarantined for i in (idxs or ())}
    for (f, d), (clock, heads, props) in finals.items():
        res.states += 1
        doc = docs[d]
        bad = _problems(ref_mod, doc, key, clock, heads, doc.max_op, 0,
                        props, [])
        if bad:
            res.state_mismatches += 1
            res.note(f"state doc {d}: " + "; ".join(bad[:3]))
        for actor, seq in doc.clock.items():
            lost.update(index[(actor, s)]
                        for s in range(clock.get(actor, 0) + 1, seq + 1))
    made = set(driver.made)
    res.failed = len(lost & made)
    res.attempted = len(made)
    return res
