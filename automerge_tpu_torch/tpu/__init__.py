"""Device layer of the port: merge engine, paged slab, farm, batched sync
and the Bloom kernels (module names mirror the JAX package's ``tpu/``).

The engine-level API is the JAX package's: a ``BatchTranscoder`` packs
frontend op dicts into a ``ChangeOpsBatch``, which ``BatchedMapEngine``
(paged) or the dense state (``make_empty_state`` + ``batched_apply_ops``,
read by ``batched_visible_state``) merges on the card."""
# engine and paging import each other (engine binds paging's programs
# mid-module): load engine first, whichever module a caller names
from .engine import (  # noqa: F401
    ACTION_DEL,
    ACTION_INC,
    ACTION_SET,
    BatchedDocState,
    BatchedMapEngine,
    ChangeOpsBatch,
    PAD_KEY,
    batched_apply_ops,
    batched_visible_state,
    make_empty_state,
    pack_opid,
    unpack_opid,
)
from . import decode  # noqa: E402, F401  (registers the vectorized decode backend)
from .transcode import BatchTranscoder  # noqa: E402, F401
