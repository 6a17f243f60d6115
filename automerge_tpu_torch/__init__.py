"""automerge_tpu_torch: the document merge farm and its batched sync in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``automerge_tpu``, which stays beside it as the
reference. This package imports neither JAX nor anything of
``automerge_tpu``: the host-only modules it needs are its own copies.
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).

    from automerge_tpu_torch import SyncFarm, TorchDocFarm

    farm = TorchDocFarm(num_docs=1024)          # on the card
    sync = SyncFarm(farm)
    session = sync.make_session(0)              # one supervised channel

A single-document peer runs over ``backend`` with ``SyncSession`` and
``BackendDriver``; ``encode_sync_state``/``decode_sync_state`` persist a
channel's sync state. A durable server hydrates from its write-ahead log
and serves clients through the batching front door:

    from automerge_tpu_torch.serve import AmServer
    from automerge_tpu_torch.store import open_farm

    farm, store = open_farm("shard-000", num_docs=1024)  # cold start
    server = AmServer(farm)                     # sessions + DynamicBatcher
"""
from .sync import decode_sync_state, encode_sync_state
from .sync_session import BackendDriver, SessionConfig, SyncSession
from .tpu.farm import TorchDocFarm
from .tpu.sync_farm import SyncFarm

__all__ = [
    "BackendDriver",
    "SessionConfig",
    "SyncFarm",
    "SyncSession",
    "TorchDocFarm",
    "decode_sync_state",
    "encode_sync_state",
]
