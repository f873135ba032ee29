from .distributed import (
    global_shard_batch,
    initialize,
    replicate_to_mesh,
)
from .mesh import (
    DATA_AXIS,
    batch_sharded,
    make_mesh,
    make_parallel_eval_step,
    make_parallel_train_step,
    replicated,
    shard_batch,
)
