"""Doc-sharded execution: shard-local farms (meshfarm.py) behind one
controller, the ('dp', 'sp') device grid (mesh.py), the process-worker
runtime (workers.py) and its shared-memory data plane (shm.py).

Exports resolve lazily (PEP 562): a spawned mesh worker child imports
``automerge_tpu_torch.parallel.workers`` through this package, and an
eager ``from .meshfarm import MeshFarm`` here would drag the controller —
and torch — into every child before its own imports run (pinned by
tests/test_torch_mesh_workers.py).
"""
__all__ = ["MeshFarm", "make_mesh"]


def __getattr__(name):
    if name == "MeshFarm":
        from .meshfarm import MeshFarm
        return MeshFarm
    if name == "make_mesh":
        from .mesh import make_mesh
        return make_mesh
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
