"""Device layer of the port: merge engine, paged slab, farm, batched sync
and the Bloom kernels (module names mirror the JAX package's ``tpu/``)."""
