"""1-D data parallelism across GPUs (unidefense_tpu/parallel/mesh.py:1-136),
in PyTorch's idiom: one process (rank) per GPU.

The JAX package drives every local device from one process through
``shard_map`` over a Mesh(('data',)). Here each rank sees what one JAX
device sees:

* its own real-first sub-batch (``train_batch_size`` real, then as many
  fake frames), drawn from samplers sharded ``shard_id = rank``,
  ``num_shards = world``, so ``sum_real``/``sum_fake`` and the triplet loss
  stay per rank, as they are per device in JAX (and per rank in the
  reference's DDP);
* BatchNorm statistics synced over the ranks (:func:`sync_batchnorm`, the
  pmean of E[x] and E[x^2] of ``layers.BatchNorm(axis_name=...)``);
* gradients averaged over the ranks after each backward pass
  (:func:`mean_gradients`, ``lax.pmean(g)``) and the step's metrics averaged
  before they are returned (``lax.pmean(metrics)``).

A world of one rank creates no process group, and every function here is
then what the single-card port does. Ranks come from ``torchrun`` (its
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``), from :func:`launch` (``python -m unidefense_torch.main
--num_devices N``, which spawns N ranks on this host and sets the same
variables), or from a caller that initialised ``torch.distributed``
itself. NCCL carries the collectives on the GPU, gloo on the CPU; on CUDA
tensors gloo carries ``all_reduce`` and ``broadcast`` only, which is all the
step, BatchNorm and the state broadcast use. Object gathers go through
pickles (``all_gather_object``).

The 2-D mode (``create_mesh_2d``, ``state_shardings``,
``gspmd_train_step``) and the hybrid mesh (mesh.py:124-221) are the one
module of the JAX package the port does not have yet (ROADMAP.md: the 2-D
mode and the hybrid mesh); the optimizers and ``remat`` are ported.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from unidefense_torch.device import DeviceLike, resolve_device

# finite: a rank that dies while the others wait in a collective ends the
# run within this time even where no launcher terminates them
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
# gradient and state tensors are reduced in flat buckets of at most this size
BUCKET_BYTES = 25 << 20
# seconds the launcher gives the other ranks after one fails, before SIGTERM
# and again before SIGKILL
GRACE_SECONDS = 5.0


@dataclass
class DataParallel:
    """Where this process stands in the data-parallel world: its rank, the
    world size, its rank on this host, the process group (None for a world
    of one) and its device. ``create_mesh``'s counterpart."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    group: Optional[dist.ProcessGroup] = None
    device: torch.device = torch.device("cpu")

    @property
    def primary(self) -> bool:
        """Rank 0: the rank that prints, logs and writes checkpoints."""
        return self.rank == 0


def _env_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1") or 1)


def init_data_parallel(num_devices: Optional[int] = None, backend: Optional[str] = None,
                       device: DeviceLike = None) -> DataParallel:
    """This process's place in the data-parallel world.

    An initialised ``torch.distributed`` default group is used as it is.
    Otherwise a ``WORLD_SIZE`` above 1 in the environment (``torchrun``,
    :func:`launch`) is joined with ``init_method="env://"`` on ``backend``
    (None: NCCL for a CUDA device, gloo for the CPU). A world of one creates
    no group. ``num_devices``, if given, must equal the world size.

    The device: ``device`` as :func:`resolve_device` reads it, except that
    in a world above one a CUDA device without an index becomes
    ``cuda:<local rank>``, made the current device (NCCL's object
    collectives use it)."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = _env_world(), int(os.environ.get("RANK", "0") or 0)
    local_rank = int(os.environ.get("LOCAL_RANK", rank) or 0)
    if num_devices is not None and int(num_devices) != world:
        if world == 1:
            raise ValueError(
                f"num_devices={num_devices}: one process drives one device; start one rank per "
                "device with `python -m unidefense_torch.main --num_devices N` or with torchrun")
        raise ValueError(f"num_devices={num_devices}, but the world has {world} ranks")
    dev = resolve_device(device)
    if world == 1:
        return DataParallel(device=dev)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method="env://", world_size=world, rank=rank,
                                timeout=DEFAULT_TIMEOUT)
    return DataParallel(rank=rank, world=world, local_rank=local_rank, group=dist.group.WORLD,
                        device=dev)


def all_gather_objects(*objects, group: Optional[dist.ProcessGroup] = None) -> list:
    """Every rank's ``objects`` tuple, in rank order (dist.all_gather_object;
    engine/forgery_engine.py:374-375). One process: ``[objects]``."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size(group) == 1:
        return [objects]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, objects, group=group)
    return out


def broadcast_object(obj, group: Optional[dist.ProcessGroup] = None, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank; ``obj`` itself in one process."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def split_device_batch(images_real, labels_real, images_fake, labels_fake, num_devices: int):
    """Interleave per-device [real ‖ fake] blocks into the layout
    [d0-real, d0-fake, d1-real, d1-fake, ...] (numpy). Raises ValueError on
    batches that ``num_devices`` does not divide: truncating would upset the
    per-device real-first split the triplet loss depends on."""
    if images_real.shape[0] % num_devices or images_fake.shape[0] % num_devices:
        raise ValueError(
            f"real batch {images_real.shape[0]} / fake batch "
            f"{images_fake.shape[0]} not divisible by {num_devices} devices"
        )
    nr = images_real.shape[0] // num_devices
    nf = images_fake.shape[0] // num_devices
    imgs, lbls = [], []
    for d in range(num_devices):
        imgs.append(images_real[d * nr : (d + 1) * nr])
        imgs.append(images_fake[d * nf : (d + 1) * nf])
        lbls.append(labels_real[d * nr : (d + 1) * nr])
        lbls.append(labels_fake[d * nf : (d + 1) * nf])
    return np.concatenate(imgs, axis=0), np.concatenate(lbls, axis=0)


def _buckets(tensors: Iterable[torch.Tensor]) -> Iterator[list]:
    """Runs of consecutive tensors of one dtype and device, each run at most
    BUCKET_BYTES (or one tensor larger than that)."""
    bucket, size, key = [], 0, None
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and ((t.dtype, t.device) != key or size + nbytes > BUCKET_BYTES):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
        key = (t.dtype, t.device)
    if bucket:
        yield bucket


def _flat_apply(tensors: Iterable[torch.Tensor], collective: Callable[[torch.Tensor], None]):
    """Flatten each bucket, run ``collective`` on it in place, and copy the
    result back into the tensors."""
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(v.view(t.shape))


@torch.no_grad()
def mean_gradients(model: torch.nn.Module, group: dist.ProcessGroup) -> None:
    """``lax.pmean(g)``: every ``.grad`` replaced by its mean over the
    ranks, in place (sums in buckets, then divided by the world size)."""
    world = dist.get_world_size(group)

    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    _flat_apply([p.grad for p in model.parameters() if p.grad is not None], mean)


@torch.no_grad()
def all_reduce_mean(values: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The mean over the ranks of a tensor (one collective), as a new tensor."""
    out = values.clone()
    dist.all_reduce(out, group=group)
    return out.div_(dist.get_world_size(group))


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, opt_state=None,
                    group: Optional[dist.ProcessGroup] = None, src: int = 0) -> None:
    """Rank ``src``'s parameters, buffers and every per-tensor slot of the
    optimizer state on every rank, in place. Nothing to do without a
    group. (The state's count and ``scalars`` follow from the count, the
    same on every rank.)"""
    if group is None:
        return
    tensors = list(model.state_dict().values())
    if opt_state is not None:
        tensors += opt_state.tensors()
    _flat_apply(tensors, lambda flat: dist.broadcast(flat, src=src, group=group))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose gradient is the sum over the ranks of the
    gradient: the transpose JAX takes for ``psum`` under ``check_vma=False``
    (parallel/mesh.py:41-42)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def sync_batchnorm(model: torch.nn.Module, group: Optional[dist.ProcessGroup]) -> torch.nn.Module:
    """Give every ``layers.BatchNorm`` of ``model`` the group its training
    statistics are synced over (``SyncBatchNorm.convert_sync_batchnorm``'s
    counterpart); None turns the sync off. Returns ``model``."""
    from unidefense_torch.models.layers import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return model


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_num_devices(num_devices: int, device: DeviceLike = None) -> None:
    """Raise ValueError unless ``num_devices`` ranks fit this host: at most
    its card count on ``cuda`` (``device`` None or a CUDA device), any
    number on the CPU."""
    if int(num_devices) < 1:
        raise ValueError(f"num_devices={num_devices}")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and int(num_devices) > torch.cuda.device_count():
        raise ValueError(f"num_devices={num_devices} exceeds the {torch.cuda.device_count()} "
                         "CUDA device(s) of this host")


def _rank_entry(index: int, fn: Callable, args: tuple, world: int, port: int) -> None:
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, num_devices: int, args: tuple = (), device: DeviceLike = None,
           timeout: Optional[float] = None) -> None:
    """Run ``fn(*args)`` on ``num_devices`` ranks of this host, one spawned
    process each, with the rendezvous on 127.0.0.1 at a free port in their
    environment (as ``torchrun`` sets it), and return when every rank has
    returned. ``fn`` is importable (spawn pickles it) and joins the world
    through :func:`init_data_parallel`. On ``cuda`` (``device`` None or a
    CUDA device), ``num_devices`` above the cards this host has raises
    ValueError; JAX's ``create_mesh`` takes fewer instead. If a rank fails,
    the others are terminated and the failure is raised here; past
    ``timeout`` seconds (None: no limit) every rank is killed and
    TimeoutError raised."""
    import time

    import torch.multiprocessing as mp

    check_num_devices(num_devices, device)
    ctx = mp.start_processes(_rank_entry, args=(fn, tuple(args), int(num_devices), free_port()),
                             nprocs=int(num_devices), join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    while not ctx.join(timeout=None if deadline is None else 1.0, grace_period=GRACE_SECONDS):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
                p.join()
            raise TimeoutError(f"{num_devices} ranks still running after {timeout} s; killed")
