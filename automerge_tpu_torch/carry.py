"""Carries documents exported by the JAX farm into this package's farm.

For this system the "weights" are document state. ``TpuDocFarm.export_doc``
(the JAX package) returns a self-contained dict — numpy row columns, the
farm's interner tables and the host bookkeeping — and
``TorchDocFarm.adopt_doc`` installs such a dict. The two differ only in
types: the JAX farm's interned values are its own ``ValueCell`` /
``ChildObj`` NamedTuples, its errors its own taxonomy classes, and a list
document's embedded sequential walk its own ``OpSet``. This module converts
them by field (duck typing, so nothing of the JAX package is imported); a
walk cannot cross, so it is rebuilt here as this package's ``OpSet`` from
the carried change log and queue, as the farm bootstraps one. That holds
for a document in the JAX farm's degraded mode too (served by its walk
after a failed device dispatch): its walk is rebuilt the same way, and it
stays degraded here.
"""
from __future__ import annotations

import numpy as np

from .errors import error_from_kind
from .tpu.farm import ChildObj, ValueCell, replay_walk

_ROW_COLUMNS = ("key", "op", "action", "value", "pred", "overwritten")

_CARRIED = (
    "object_meta", "clock", "heads", "queue", "changes", "change_index",
    "hashes_by_actor", "deps_by_hash", "dependents", "max_op",
    "counter_ops", "inc_max", "starved", "children", "degraded", "fault_count",
    "num_elems", "elem_index", "elem_ids", "elem_object",
)


def _convert_value(cell):
    if hasattr(cell, "object_id"):
        return ChildObj(cell.object_id)
    if hasattr(cell, "value") and hasattr(cell, "datatype"):
        return ValueCell(cell.value, cell.datatype)
    raise TypeError(f"unknown interned value {cell!r}")


def doc_from_jax_export(export: dict) -> dict:
    """The dict ``TorchDocFarm.adopt_doc`` takes, from the dict
    ``TpuDocFarm.export_doc`` returned."""
    rows = export["rows"]
    out = {
        "rows": {
            name: np.asarray(rows[name], bool if name == "overwritten"
                             else np.int64).copy()
            for name in _ROW_COLUMNS
        },
        "actor_table": [str(a) for a in export["actor_table"]],
        "slot_table": [tuple(s) for s in export["slot_table"]],
        "value_table": [_convert_value(c) for c in export["value_table"]],
        "elem_opid": np.asarray(export["elem_opid"], np.int64).copy(),
        "elem_parent": np.asarray(export["elem_parent"], np.int32).copy(),
    }
    for name in _CARRIED:
        out[name] = export[name]
    out["exact"] = (
        None if export["exact"] is None
        else replay_walk(export["changes"], export["queue"])
    )
    cause = export["quarantine"]
    out["quarantine"] = None if cause is None else error_from_kind(
        getattr(cause, "kind", "other"), str(cause)
    )
    return out
