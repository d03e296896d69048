"""Process groups, device meshes and sharding policies (counterpart of
``polyffusion_tpu/parallel``): data parallelism over a ``dp`` mesh, ZeRO-3
state sharding with FSDP2 (``fsdp.py``) and Megatron tensor parallelism on a
("dp", "tp") mesh (``tp.py``)."""

from .fsdp import MIN_SHARD_ELEMS, infer_fsdp_sharding, shard_state_fsdp  # noqa: F401
from .mesh import (  # noqa: F401
    batch_sharding,
    init_on_cpu,
    init_process_group,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_batch,
)
from .tp import infer_tp_sharding, make_tp_mesh, shard_state  # noqa: F401
