"""Training in several processes, one device each: the process group and
the sums across processes (`mesh`, `collectives`)."""
from dro_sfm_torch.parallel.collectives import (
    all_reduce_metric_sums,
    all_reduce_sum,
    any_process_flag,
    average_gradients,
    average_loss_and_metrics,
    average_metrics,
    broadcast_flag,
    broadcast_tensors,
    reduce_dict,
)
from dro_sfm_torch.parallel.mesh import (
    is_distributed,
    is_rank0,
    local_device,
    maybe_init_distributed,
    process_count,
    process_index,
)

__all__ = ["all_reduce_metric_sums", "all_reduce_sum", "any_process_flag",
           "average_gradients", "average_loss_and_metrics", "average_metrics",
           "broadcast_flag", "broadcast_tensors", "reduce_dict", "is_distributed",
           "is_rank0", "local_device", "maybe_init_distributed", "process_count",
           "process_index"]
