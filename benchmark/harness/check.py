"""The output check: what the timed path returned, held to the plain
reference (``benchmark/reference``; `check` takes the module of the
stream's schema, ``reference/<schema>.py``).

Four numbers, each with the limit 0 (the comparison is exact):

- ``patch_mismatches``: returned patches that disagree with the reference.
  A patch's clock must name a causally closed set of changes; for a
  delivery the driver made (not one a sync chose) that set must be the
  one delivered, with no change pending. Its heads and maxOp must be that
  set's. Every value it lists must be visible in the reference with the
  same value (a counter with its total). Every root key that an op newly
  committed by the call sets or increments must be listed, with every op
  of the key that is visible and whose id is no greater than the least id
  of those new ops. backend/new.js lists no more for certain: it walks a
  key's ops in id order, and where one actor's consecutive ops in a call
  go on to a greater key it leaves the walk of the first key at its own op,
  so a visible op of greater id is listed only by some orders of
  application, which the sync chooses.
- ``state_mismatches``: (farm, document) pairs whose whole state after the
  window, read through ``get_patch``, differs from the reference's state
  of every change made on the document.
- ``failed``: changes of the window that some farm lost: quarantined, or
  missing from its clock after the window.
- ``unquiesced_epochs``: sync epochs still moving messages after the sync
  loop's ``MAX_SWEEPS`` sweeps.
"""
from __future__ import annotations

from reference import RootMap, opid

MAX_NOTES = 8


class CheckResult:
    def __init__(self):
        self.patch_mismatches = 0
        self.state_mismatches = 0
        self.failed = 0
        self.unquiesced = 0
        self.patches = 0
        self.states = 0
        # what the run attempted; a loop's own check sets it (run.py
        # counts the changes made for the farm loops' check)
        self.attempted = None
        self.notes: list[str] = []

    def note(self, text):
        if len(self.notes) < MAX_NOTES:
            self.notes.append(text)

    def numbers(self):
        """[(name, value, limit)] in print order."""
        return [("patch_mismatches", self.patch_mismatches, 0),
                ("state_mismatches", self.state_mismatches, 0),
                ("failed_changes", self.failed, 0),
                ("unquiesced_epochs", self.unquiesced, 0)]

    @property
    def correct(self):
        return all(v <= limit for _, v, limit in self.numbers())


def _order(ch, idxs):
    """A causal commit order for changes each of whose deps has a lower
    start op (so it is in every generator's streams): by start op, then
    actor, then seq."""
    return sorted(idxs, key=lambda i: (ch.start_op[i], ch.actor[i],
                                       ch.seq[i]))


def check(ref_mod, stream, records, finals, window_changes, quarantined,
          unquiesced=0):
    """`ref_mod`: the reference module of the stream's schema; `records`:
    the driver's snapshots in call order; `finals`: its ``finals()``;
    `window_changes`: change indices made in the window; `quarantined`:
    the driver's (farm, doc, indices) losses; `unquiesced`: its epochs
    given up."""
    ch = stream.changes
    res = CheckResult()
    res.unquiesced = unquiesced
    index = ch.by_author()
    refs: dict = {}
    committed: dict = {}
    known: dict = {}
    for snap in records:
        key = (snap.farm, snap.doc)
        ref = refs.setdefault(key, RootMap())
        have = committed.setdefault(key, set())
        clock = known.setdefault(key, {})
        res.patches += 1
        bad = []
        newly = []
        for actor, seq in snap.clock.items():
            for s in range(clock.get(actor, 0) + 1, seq + 1):
                i = index.get((actor, s))
                if i is None or ch.doc[i] != snap.doc:
                    bad.append(f"clock names {actor[:8]}:{s}, made by no "
                               "change of this document")
                else:
                    newly.append(i)
            if seq < clock.get(actor, 0):
                bad.append(f"clock of {actor[:8]} went back")
        clock.update(snap.clock)
        newly = _order(ch, newly)
        fresh = {ch.hash[i] for i in newly}
        for i in newly:
            missing = [h for h in ch.deps[i] if h not in have
                       and h not in fresh]
            if missing:
                bad.append(f"change {ch.hash[i][:8]} committed before "
                           f"its deps {[h[:8] for h in missing]}")
        least = {}
        for i in newly:
            ref_mod.commit(ref, ch, i)
            have.add(ch.hash[i])
            for name, op in ref_mod.ops(ch, i):
                least[name] = min(least.get(name, op), op)
        if snap.delivered is not None:
            if sorted(newly) != sorted(snap.delivered):
                bad.append(f"{len(snap.delivered)} changes delivered, "
                           f"{len(newly)} committed")
            if snap.pending:
                bad.append(f"{snap.pending} changes pending")
        if sorted(snap.deps) != sorted(ref.heads):
            bad.append("heads differ")
        if snap.max_op != ref.max_op:
            bad.append(f"maxOp {snap.max_op}, want {ref.max_op}")
        bad.extend(_props_problems(ref, snap.props))
        bad.extend(_unlisted(ref, snap.props, least))
        if bad:
            res.patch_mismatches += 1
            res.note(f"patch farm {snap.farm} doc {snap.doc}: "
                     + "; ".join(bad[:3]))

    # the whole state of every document after the window
    want = _due(stream, records, finals)
    states = {}     # the farms of a sync are due the same changes
    for (f, d), (clock, heads, props) in finals.items():
        res.states += 1
        due = tuple(want[(f, d)])
        if due not in states:
            ref = RootMap()
            for i in _order(ch, due):
                ref_mod.commit(ref, ch, i)
            states[due] = (ref.clock, sorted(ref.heads), ref.whole())
        ref_clock, ref_heads, ref_props = states[due]
        if clock != ref_clock or heads != ref_heads or props != ref_props:
            res.state_mismatches += 1
            res.note(f"state farm {f} doc {d}: differs from the reference "
                     f"({sum(clock.values())} changes held, "
                     f"{sum(ref_clock.values())} due)")

    # changes of the window lost on some farm
    lost = set()
    for f, d, idxs in quarantined:
        lost.update(i for i in (idxs or []) if i in window_changes)
    for (f, d), (clock, _, _) in finals.items():
        for i in want[(f, d)]:
            if i in window_changes and clock.get(ch.actor[i], 0) < ch.seq[i]:
                lost.add(i)
    res.failed = len(lost)
    return res


def _due(stream, records, finals):
    """The changes each (farm, document) of `finals` must hold after the
    window: every change made on the document (delivered by the driver to
    some farm; a sync owes it to every farm)."""
    made = {}
    for snap in records:
        if snap.delivered is not None:
            made.setdefault(snap.doc, set()).update(snap.delivered)
    return {(f, d): sorted(made.get(d, ())) for (f, d) in finals}


def _props_problems(ref, props):
    bad = []
    for key, ops in props.items():
        for op_str, diff in ops.items():
            ctr, _, actor = op_str.partition("@")
            want = ref.diff(key, (int(ctr), actor))
            if want != diff:
                bad.append(f"{key} {op_str[:12]}: {diff}, want {want}")
    return bad


def _unlisted(ref, props, least):
    """Problems of the keys that the call's new ops touch: unlisted keys,
    and visible ops of no greater id than the key's least new op that the
    patch leaves out. `least`: {key: least (counter, actor) of the new
    ops on it}."""
    bad = []
    for key in sorted(least):
        if key not in props:
            bad.append(f"{key} not listed")
            continue
        missing = [op for op, entry in ref.props.get(key, {}).items()
                   if op <= least[key] and props[key].get(opid(*op)) is None]
        if missing:
            bad.append(f"{key} leaves out {len(missing)} visible ops")
    return bad
