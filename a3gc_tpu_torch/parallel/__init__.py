r"""Scale-out over several devices and processes (counterpart of
``a3gc_tpu/parallel``): meshes and data placement, data-parallel serving of
the cascade, multi-process training, and tensor parallelism
(:func:`param_sharding`, :func:`shard_params`, the column-parallel products
of :mod:`a3gc_tpu_torch.parallel.tensor`). ``cascade_apply_sharded`` is
imported on first use: the nets import :mod:`.tensor`, and the serving
module imports the nets."""
from a3gc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    ParamSharding,
    batch_sharding,
    make_mesh,
    param_sharding,
    replicate,
    shard_batch,
    shard_params,
)
from a3gc_tpu_torch.parallel.multihost import (  # noqa: F401
    fetch_replicated,
    initialize_multihost,
    is_coordinator,
)

__all__ = ["Mesh", "ParamSharding", "batch_sharding", "cascade_apply_sharded",
           "fetch_replicated", "initialize_multihost", "is_coordinator",
           "make_mesh", "param_sharding", "replicate", "shard_batch",
           "shard_params"]


def __getattr__(name):
    if name == "cascade_apply_sharded":
        from a3gc_tpu_torch.parallel.serving import cascade_apply_sharded
        return cascade_apply_sharded
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
