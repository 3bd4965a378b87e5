"""Several processes on ``torch.distributed`` (PyTorch counterpart of
``magvit2_pytorch_tpu/parallel``): process bring-up, the mesh and its
placement helpers, and the global-batch terms of a data-parallel step."""

from magvit2_pytorch_tpu_torch.parallel.batch import (
    BatchShard,
    global_mean,
    global_row_mean,
    rand_rows,
    sharded_batch,
)
from magvit2_pytorch_tpu_torch.parallel.distributed import (
    initialize_distributed,
    process_count,
    process_index,
)
from magvit2_pytorch_tpu_torch.parallel.mesh import (
    Mesh,
    batch_axes,
    batch_index,
    data_parallel_extent,
    is_main_process,
    make_mesh,
    replicate,
    shard_batch,
    shard_params_tensor_parallel,
    tensor_parallel_shardings,
)
