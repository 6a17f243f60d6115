"""automerge_tpu_torch: the map/counter merge farm and its batched Bloom
sync in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``automerge_tpu``, which stays beside it as the
reference. This package imports neither JAX nor anything of
``automerge_tpu``: the host-only modules it needs are its own copies.
Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).

    from automerge_tpu_torch import SyncFarm, TorchDocFarm

    farm = TorchDocFarm(num_docs=1024)          # on the card
    sync = SyncFarm(farm)
"""
from .tpu.farm import TorchDocFarm
from .tpu.sync_farm import SyncFarm

__all__ = ["SyncFarm", "TorchDocFarm"]
