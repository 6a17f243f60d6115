"""UUID generation for actor IDs and table row IDs, with a swappable factory
for deterministic tests (port of the reference implementation's src/uuid.js).

The port's own copy of the JAX package's ``uuid.py``: its factory is this
module's, so ``set_factory`` here does not reach the JAX package, nor the
other way round."""
# amlint: host-only — pure-host layer: must not import tpu/ or torch
from __future__ import annotations

import uuid as _stdlib_uuid


def _default_factory() -> str:
    return _stdlib_uuid.uuid4().hex


_factory = _default_factory


def make_uuid() -> str:
    return _factory()


def set_factory(factory) -> None:
    global _factory
    _factory = factory


def reset_factory() -> None:
    global _factory
    _factory = _default_factory
