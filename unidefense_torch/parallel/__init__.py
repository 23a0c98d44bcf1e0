"""Data parallelism across GPUs, one rank per device
(unidefense_tpu/parallel/): see :mod:`unidefense_torch.parallel.mesh`."""

from unidefense_torch.parallel.mesh import (
    DataParallel,
    all_gather_objects,
    all_reduce_mean,
    broadcast_object,
    broadcast_state,
    init_data_parallel,
    launch,
    mean_gradients,
    split_device_batch,
    sync_batchnorm,
)

__all__ = ["DataParallel", "all_gather_objects", "all_reduce_mean", "broadcast_object",
           "broadcast_state", "init_data_parallel", "launch", "mean_gradients",
           "split_device_batch", "sync_batchnorm"]
