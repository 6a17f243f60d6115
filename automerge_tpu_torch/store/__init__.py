"""amstore — the crash-consistent persistence tier under the farm.

Three layers (full contract in wal.py's module doc):

- **atomic** (`store.atomic`): ``atomic_write`` tmp+rename replacement
  with a fault-injectable fsync seam — the one blessed writer for every
  durable artifact (amlint AM601 holds the durability plane to it).
- **wal** (`store.wal`): ``ShardStore`` — per-shard append-only segments
  of length+sha256-framed reference-format change chunks, group-commit
  fsync at the ack boundary, atomic rotation, torn-write truncation,
  corrupt-segment quarantine, and two-generation compaction into
  doc-grouped cold chunks with hash-graph verification.
- **hydrate** (`store.hydrate`): ``open_farm`` batched cold start —
  every recovered segment flows through ``warm_decode_cache``'s
  vectorized path into farm pages in one delivery, then the persisted
  quarantine sidecar is restored.

This is the port's own copy of the JAX package's ``store`` package. The
on-disk format is the contract: for the same commits both packages write
byte-identical segment, manifest and sidecar files, so a directory either
package wrote hydrates the other's farm. Importing this package never
touches the device; only an actual hydration pulls in the farm.
"""
from .atomic import atomic_write, fsync_dir, fsync_file
from .hydrate import hydrate_farm, open_farm, quarantine_snapshot
from .wal import (MANIFEST_NAME, QUARANTINE_NAME, RecoveryReport, ShardStore,
                  StoreConfig)

__all__ = [
    "atomic_write",
    "fsync_dir",
    "fsync_file",
    "hydrate_farm",
    "open_farm",
    "quarantine_snapshot",
    "ShardStore",
    "StoreConfig",
    "RecoveryReport",
    "MANIFEST_NAME",
    "QUARANTINE_NAME",
]
