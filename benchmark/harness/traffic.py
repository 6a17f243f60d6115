"""The benchmark's traffic, made in set-up from ``--seed``. A cell's
configuration file (``configs/<config>.json``) gives the deployment: its
``schema`` names the generator (``schemas/<schema>.py``, found through
`plugins`), the documents, replicas or actors, the fields and the
document popularity. Its traffic file (``traffic/<mix>.json``) gives the
loop and the sizes of the steps. The same seed gives the same bytes.

A stream is a list of *steps* (an epoch, a flush or a round), each a list
of deliveries ``(source, [change index, ...])`` in causal order, plus the
records of every change (`Changes`), which the plain reference reads.
Actor ids are drawn per document, so no two documents share a change.

This module holds what every generator shares: the records, the
popularity, the actor ids and the worker processes that encode a large
stream."""
from __future__ import annotations

import hashlib
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

from . import plugins

#: processes that encode a large stream (started in set-up, then ended)
MAX_WORKERS = 8
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Changes:
    """Records of every change of a stream, in generation order.

    Per change: ``doc``, ``actor`` (hex), ``seq``, ``start_op``, ``nops``,
    ``deps`` (hex hashes), ``hash`` (hex), ``data`` (the bytes). A
    generator adds the op records of its schema as further lists (named
    in `op_fields`), which its reference module reads."""

    HEADER = ("doc", "actor", "seq", "start_op", "nops", "deps", "hash",
              "data")

    def __init__(self, schema: str, op_fields=()):
        self.schema = schema
        self.op_fields = tuple(op_fields)
        for name in self.HEADER + self.op_fields:
            setattr(self, name, [])
        self._by_author = None

    def fill(self, rows) -> None:
        """Sets every column from `rows`, each (header..., op fields...)
        in the order of ``HEADER + op_fields``."""
        names = self.HEADER + self.op_fields
        columns = list(zip(*rows)) if rows else [()] * len(names)
        for name, column in zip(names, columns):
            setattr(self, name, list(column))
        self._by_author = None

    def __len__(self):
        return len(self.hash)

    def by_author(self) -> dict:
        """{(actor, seq): change index}, made once."""
        if self._by_author is None:
            self._by_author = {k: i for i, k in enumerate(zip(self.actor,
                                                               self.seq))}
        return self._by_author


class Stream(NamedTuple):
    """`steps`: per step, [(source, [change index, ...])]; `changes`: the
    records; `docs`, `sources`: how many documents and sources (the
    replicas of a document, 1 where one client stands for all)."""

    steps: list
    changes: Changes
    docs: int
    sources: int


def actor_id(seed: int, doc: int, who: int, nbytes: int) -> bytes:
    """The actor id of participant `who` of document `doc`: distinct per
    document, drawn from the seed."""
    return hashlib.blake2b(f"{seed}/{doc}/{who}".encode(),
                           digest_size=nbytes).digest()


def zipf_probs(n: int, theta: float) -> np.ndarray:
    """Popularity of the `n` document ranks, Zipfian with constant `theta`
    (YCSB's zipfian request distribution; 0 is uniform). The seed maps
    ranks to documents (YCSB scrambles its ranks alike)."""
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
    return p / p.sum()


def make_stream(cfg: dict, mix: dict, seed: int, root: str | None = None):
    """The stream of configuration `cfg` under traffic `mix`, from the
    generator of its schema."""
    root = root or os.path.dirname(BENCH_DIR)
    return plugins.load(root, "schemas", cfg["schema"]).make_stream(
        cfg, mix, seed)


def workers(total: int) -> int:
    """Processes to encode `total` changes with: one below 20,000."""
    if total < 20_000:
        return 1
    return max(1, min(MAX_WORKERS, os.cpu_count() or 1))


_WORKER = """
import pickle, sys
sys.path.insert(0, {bench!r})
from harness import plugins
fn = getattr(plugins.load_path({path!r}), {name!r})
sys.stdout.buffer.write(pickle.dumps(fn(pickle.load(sys.stdin.buffer))))
"""


def run_jobs(fn, jobs):
    """[fn(job)] with each job in a worker process of its own (one job
    inline); `fn` is a function of a plug-in module. Workers are plain
    subprocesses that take the job and return the result pickled over
    their pipes: no shared memory, no semaphores."""
    if len(jobs) <= 1:
        return [fn(j) for j in jobs]
    path = sys.modules[fn.__module__].__file__
    code = _WORKER.format(bench=BENCH_DIR, path=path, name=fn.__name__)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=BENCH_DIR,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in jobs]
    try:
        with ThreadPoolExecutor(len(jobs)) as pool:
            outs = list(pool.map(lambda pj: pj[0].communicate(
                pickle.dumps(pj[1]))[0], zip(procs, jobs)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("a stream worker failed")
    return [pickle.loads(out) for out in outs]
