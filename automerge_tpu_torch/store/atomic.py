"""``atomic_write`` — crash-safe whole-file replacement with an fsync seam.

Every durable artifact that is replaced as a unit — the store's
manifests, compacted chunks and the quarantine sidecar — goes through
this one helper: write
to a pid-tagged temp name in the target directory, flush, fsync,
``os.replace`` over the destination, fsync the directory entry. A crash
at any instant leaves either the old file or the new file on disk, never
a torn mix (rename within one directory is atomic on POSIX).

The fsync seam (``fsync_file``/``fsync_dir``) is the fault-injectable
durability boundary: it fires the ``store.fsync`` failure point
(testing/faults.py) before touching the kernel, so the crash-point sweep
can abort a workload at every sync without a real power cut. amlint rule
AM601 holds the durability-plane modules to this writer — raw write
handles below are the rule's justified escape hatch.
"""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import os


def _fire(point: str, **context) -> None:
    # Late import: testing.faults pulls in columnar/obs — binding at call
    # time keeps the import graph acyclic.
    from ..testing.faults import fire

    fire(point, **context)


def fsync_file(fh) -> None:
    """Flushes and fsyncs an open file object (the durability boundary for
    data bytes). Fires the ``store.fsync`` failure point first."""
    _fire("store.fsync", path=getattr(fh, "name", "<fd>"))
    fh.flush()
    os.fsync(fh.fileno())


def fsync_dir(path: str) -> None:
    """Fsyncs a directory so a rename/unlink inside it is durable (the
    durability boundary for file *names*). Fires ``store.fsync``."""
    _fire("store.fsync", path=path)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path, data, fsync: bool = True) -> None:
    """Replaces ``path`` with ``data`` (str or bytes) atomically.

    With ``fsync`` (the default) both the bytes and the directory entry
    are synced, so the replacement survives a power cut; without it the
    write is still atomic against process crashes (rename is the commit
    point) but rides the OS writeback cache."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    if isinstance(data, str):
        # amlint: disable=AM601 — this IS the atomic writer the rule points at
        fh = open(tmp, "w", encoding="utf-8")
    else:
        # amlint: disable=AM601 — this IS the atomic writer the rule points at
        fh = open(tmp, "wb")
    try:
        with fh:
            fh.write(data)
            if fsync:
                fsync_file(fh)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if fsync:
        fsync_dir(os.path.dirname(path) or ".")
