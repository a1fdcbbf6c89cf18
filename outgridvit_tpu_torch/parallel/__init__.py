"""Data × model parallelism (twin of ``outgridvit_tpu/parallel``) on
``torch.distributed``: the mesh and its sharding rules (``mesh.py``), the
multi-process layer (``distributed.py``) and the collectives the step runs
(``collectives.py``)."""

from outgridvit_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    mesh_of,
    param_pspec,
    shard_model,
    shard_train_state,
    superbatch_sharding,
)
from outgridvit_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize as initialize_distributed,
    is_main_process,
    local_row_slice,
    process_count,
    process_index,
    replicate_to_host,
    shard_loader_for_process,
    shutdown as shutdown_distributed,
    warmup_collectives,
)
