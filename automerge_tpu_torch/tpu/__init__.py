"""Device layer of the port: merge engine, paged slab, farm, batched sync
and the Bloom kernels (module names mirror the JAX package's ``tpu/``)."""
# engine and paging import each other (engine binds paging's programs
# mid-module): load engine first, whichever module a caller names
from . import engine  # noqa: F401
