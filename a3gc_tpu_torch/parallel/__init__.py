r"""Scale-out over several devices and processes (counterpart of
``a3gc_tpu/parallel``): meshes and data placement, data-parallel serving of
the cascade, and multi-process training. Tensor parallelism (the JAX
package's ``param_sharding`` / ``shard_params``) is not ported."""
from a3gc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    replicate,
    shard_batch,
)
from a3gc_tpu_torch.parallel.multihost import (  # noqa: F401
    fetch_replicated,
    initialize_multihost,
    is_coordinator,
)
from a3gc_tpu_torch.parallel.serving import cascade_apply_sharded  # noqa: F401
