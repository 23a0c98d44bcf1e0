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

The 2-D mode (mesh.py:124-221) is the second half of this module: a
``DeviceMesh`` of shape (dp, mp) named ('data', 'model')
(:func:`create_mesh_2d`, :func:`create_hybrid_mesh`), the step with
global-batch semantics over 'data' (``train.step.make_train_step(...,
mesh=...)``) and the large weights and their optimizer slots sharded on
their output axis over 'model' (:func:`shard_plan`,
:func:`gspmd_train_step`, :func:`gather_state`). What GSPMD inserts there
is explicit here: each rank holds rows [r N/dp, (r+1) N/dp) of the global
batch, the batch-coupled losses run on tensors gathered over 'data', every
draw is made at the global batch's shape and cut to the rank's rows
(:class:`BatchRows`), gradients are summed over 'data', and each sharded
weight is gathered whole over 'model' before the forward reads it.
"""

from __future__ import annotations

import datetime
import os
import socket
from dataclasses import dataclass, field
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
DATA_AXIS = "data"
MODEL_AXIS = "model"


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


# ------------------------------------------------------------------- 2-D mode
# (unidefense_tpu/parallel/mesh.py:124-221) A ('data', 'model') mesh with
# global-batch semantics: the step sees the whole [reals ‖ fakes] batch,
# rows [r N/dp, (r+1) N/dp) on data rank r, and the weights that
# ``shard_plan`` picks are sharded on their output axis over 'model'.

@dataclass
class Mesh2D:
    """A ('data', 'model') mesh and this rank's place in it
    (``create_mesh_2d``'s Mesh). Rank r*mp + m sits at data row r and model
    column m, as JAX lays its devices out (``devices.reshape(n // mp, mp)``).
    ``data_group`` joins the dp ranks of this rank's model column (other
    rows of the batch, the same shards), ``model_group`` the mp ranks of its
    data row (the same rows, one shard each); a group is None where its axis
    has one rank, and a 1x1 mesh has no ``DeviceMesh``."""

    dp: int = 1
    mp: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    mesh: Optional[object] = None  # torch.distributed.device_mesh.DeviceMesh
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    rank: int = 0
    model_root: int = 0  # the global rank at model index 0 of this rank's data row

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.dp:
            raise ValueError(f"a global batch of {n} does not split over {self.dp} data ranks")
        per = n // self.dp
        return slice(self.data_index * per, (self.data_index + 1) * per)


def _world_before_joining() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return _env_world()


def _mesh_from_grid(grid: np.ndarray, dp: DataParallel) -> Mesh2D:
    """The Mesh2D of this rank on a (dp, mp) grid of ranks."""
    rows, mp = grid.shape
    if dp.world == 1:
        return Mesh2D(device=dp.device)
    if dp.device.type == "cuda" and dist.get_backend() == "gloo":
        raise ValueError("the 2-D mode gathers CUDA tensors, which gloo does not carry: run "
                         "one rank per card over NCCL")
    from torch.distributed.device_mesh import DeviceMesh

    r, m = (int(i) for i in np.argwhere(grid == dp.rank)[0])
    mesh = DeviceMesh(dp.device.type, torch.as_tensor(grid), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh2D(dp=rows, mp=mp, data_index=r, model_index=m,
                  data_group=mesh.get_group(DATA_AXIS) if rows > 1 else None,
                  model_group=mesh.get_group(MODEL_AXIS) if mp > 1 else None,
                  mesh=mesh, device=dp.device, rank=dp.rank, model_root=int(grid[r, 0]))


def create_mesh_2d(num_devices: Optional[int] = None, model_parallel: int = 1,
                   device: DeviceLike = None) -> Mesh2D:
    """('data', 'model') mesh over the world's ranks: dp = n // mp rows of mp
    ranks. ``num_devices`` (None: the world) must equal the world size, and
    n % mp raises JAX's ValueError before the world is joined; the world is
    joined as :func:`init_data_parallel` joins it. On CUDA the collectives
    need NCCL: a gloo world on CUDA tensors raises."""
    n = _world_before_joining() if num_devices is None else int(num_devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    dp = init_data_parallel(num_devices, None, device)
    return _mesh_from_grid(np.arange(dp.world).reshape(dp.world // model_parallel,
                                                       model_parallel), dp)


def hybrid_rank_grid(world: int, local_world: int, mp: int, hosts: list) -> np.ndarray:
    """``create_hybrid_mesh``'s (dp, mp) grid of ranks. ``hosts``: each rank's
    host, in rank order, L = ``local_world`` ranks on each. Each host's ranks
    form L // mp data rows of mp and the hosts' rows are stacked, so 'data'
    spans the hosts and every 'model' row stays on one (JAX's slices are the hosts here:
    ``mesh_utils.create_hybrid_device_mesh`` with dcn (hosts, 1)). With one
    host, or where mp does not divide L, it is ``create_mesh_2d``'s grid
    (mesh.py:211-212)."""
    by_host: dict = {}
    for r, h in enumerate(hosts):
        by_host.setdefault(h, []).append(r)
    if len(by_host) <= 1 or local_world % mp:
        if world % mp:
            raise ValueError(f"{world} devices not divisible by model_parallel={mp}")
        return np.arange(world).reshape(world // mp, mp)
    if any(len(ranks) != local_world for ranks in by_host.values()):
        raise ValueError(f"ranks per host {[len(v) for v in by_host.values()]}, not "
                         f"{local_world} each")
    return np.concatenate([np.asarray(ranks).reshape(-1, mp) for ranks in by_host.values()])


def create_hybrid_mesh(model_parallel: int = 1, device: DeviceLike = None) -> Mesh2D:
    """Multi-host ('data', 'model') mesh: 'data' spans the hosts (the
    gradient sum is the only collective across them) and each 'model' row
    stays inside one host, where the weight gathers run
    (:func:`hybrid_rank_grid`). The host count is the world over
    ``LOCAL_WORLD_SIZE`` (torchrun and :func:`launch` set it), checked
    against the hosts' names gathered from every rank. On one host, or
    where a host's rank count does not divide ``model_parallel``, this is
    ``create_mesh_2d(None, model_parallel)``."""
    dp = init_data_parallel(None, None, device)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", dp.world) or dp.world)
    hosts = [h for (h,) in all_gather_objects(socket.gethostname(), group=dp.group)]
    if len(set(hosts)) != max(dp.world // local, 1):
        raise ValueError(f"{dp.world} ranks of LOCAL_WORLD_SIZE {local} make "
                         f"{dp.world // local} hosts, but they run on {len(set(hosts))}")
    return _mesh_from_grid(hybrid_rank_grid(dp.world, local, model_parallel, hosts), dp)


# ----------------------------------------------------------- shard plan

def _shard_dim(t: torch.Tensor, mp: int, min_size: int, deconv: bool) -> Optional[int]:
    """``_leaf_spec`` (mesh.py:158-165) on a torch tensor: the torch dim that
    holds the JAX layout's last axis, where the tensor has 2 or more dims,
    that axis divides by ``mp`` and the tensor holds at least ``min_size``
    elements; else None (replicated)."""
    from unidefense_torch.models.convert import jax_last_axis

    if t.dim() < 2:
        return None
    d = jax_last_axis(t.dim(), deconv)
    return d if t.shape[d] % mp == 0 and t.numel() >= min_size else None


def shard_plan(model: torch.nn.Module, opt_state=None, mp: int = 1,
               min_size: int = 1 << 16) -> dict:
    """``state_shardings``' counterpart (mesh.py:168-175), decided on the
    full (unsharded) tensors: {'params': {name: dim or None}, 'buffers':
    {name: None}, 'slots': {slot: {name: dim or None}}}, dim the torch dim
    sharded over 'model' (the JAX layout's last axis,
    ``convert.jax_last_axis``), None replicated. Buffers (the BatchNorm
    statistics) and the optimizer's count are replicated, as JAX's
    ``batch_stats`` vectors and counts are."""
    deconv = {f"{name}.weight" for name, m in model.named_modules()
              if isinstance(m, torch.nn.ConvTranspose2d)}
    params = {n: _shard_dim(p, mp, min_size, n in deconv) for n, p in model.named_parameters()}
    slots = {} if opt_state is None else {
        slot: {n: _shard_dim(t, mp, min_size, n in deconv) for n, t in tensors.items()}
        for slot, tensors in opt_state.slots.items()}
    return {"params": params, "buffers": {n: None for n, _ in model.named_buffers()},
            "slots": slots}


# ------------------------------------------------------------ collectives

def _all_gather_rows(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order
    (``all_gather_into_tensor`` on NCCL, ``all_gather`` on gloo)."""
    x = x.contiguous()
    size = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def _gather_along(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    return _all_gather_rows(x.movedim(dim, 0), group).movedim(0, dim)


class _GatherShard(torch.autograd.Function):
    """A weight gathered whole from its slices along ``dim`` over the
    'model' group; the backward is this rank's slice of the incoming
    gradient. The mp ranks of a data row hold the same rows and the same
    full weights, so their gradients of the full weight are equal: a
    reduce_scatter would scale them by mp."""

    @staticmethod
    def forward(ctx, shard, dim: int, group, index: int):
        ctx.dim, ctx.start, ctx.size = dim, index * shard.shape[dim], shard.shape[dim]
        return _gather_along(shard, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.size), None, None, None


def _memory_format(t: torch.Tensor):
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class ShardedParams:
    """The sharded weights of a model under a mesh. Each keeps this rank's
    slice as its Parameter (what the optimizer updates, as GSPMD updates a
    sharded leaf); a forward pre-hook on the model gathers each one whole
    (:class:`_GatherShard`, differentiable) into its module's attribute of
    the same name, which shadows the Parameter for the forward and the
    backward that follows (a rematerialised block's recompute reads it
    again) until :meth:`release`. The plan (:func:`shard_plan`) is kept."""

    def __init__(self, model: torch.nn.Module, plan: dict, mesh: Mesh2D):
        self.plan, self.group, self.index = plan, mesh.model_group, mesh.model_index
        self.entries = []  # (module, attribute, dim, memory format)
        for mod_name, module in model.named_modules():
            for name, p in module.named_parameters(recurse=False):
                dim = plan["params"][f"{mod_name}.{name}" if mod_name else name]
                if dim is not None:
                    self.entries.append((module, name, dim, _memory_format(p)))
                    p.data = _local_slice(p.data, dim, mesh)
        model.register_forward_pre_hook(self._gather)

    def _gather(self, model, args):
        for module, name, dim, fmt in self.entries:
            full = _GatherShard.apply(module._parameters[name], dim, self.group, self.index)
            module.__dict__[name] = full.contiguous(memory_format=fmt)

    def release(self) -> None:
        """Drop the gathered weights: the modules read their slices again."""
        for module, name, _, _ in self.entries:
            module.__dict__.pop(name, None)


def _local_slice(t: torch.Tensor, dim: int, mesh: Mesh2D) -> torch.Tensor:
    size = t.shape[dim] // mesh.mp
    return t.narrow(dim, mesh.model_index * size, size).clone(memory_format=_memory_format(t))


@torch.no_grad()
def shard_state(model: torch.nn.Module, opt_state, mesh: Mesh2D,
                min_size: int = 1 << 16) -> Optional[ShardedParams]:
    """Shard ``model``'s weights and ``opt_state``'s slots in place by
    :func:`shard_plan` (this rank keeps its slice of each) and install the
    gathers (``model.sharded``). Nothing on a mesh with one model rank."""
    if mesh.mp == 1:
        return None
    plan = shard_plan(model, opt_state, mesh.mp, min_size)
    for slot, dims in plan["slots"].items():
        tensors = opt_state.slots[slot]
        for name, dim in dims.items():
            if dim is not None:
                tensors[name] = _local_slice(tensors[name], dim, mesh)
    model.sharded = ShardedParams(model, plan, mesh)
    return model.sharded


@torch.no_grad()
def gather_state(model: torch.nn.Module, opt_state, mesh: Mesh2D) -> tuple[dict, dict]:
    """(state_dict, slots) with every sharded parameter and slot gathered
    whole, on every rank: what one process holds. Copies where nothing is
    sharded."""
    sharded = getattr(model, "sharded", None)
    plan = {"params": {}, "slots": {}} if sharded is None else sharded.plan

    def full(t, dim):
        return t.clone() if dim is None else _gather_along(t, dim, mesh.model_group)

    sd = {k: full(v, plan["params"].get(k)) for k, v in model.state_dict().items()}
    slots = {slot: {n: full(t, plan["slots"].get(slot, {}).get(n)) for n, t in tensors.items()}
             for slot, tensors in (opt_state.slots.items() if opt_state is not None else ())}
    return sd, slots


class _GatherRows(torch.autograd.Function):
    """Tensors whose dim 0 holds this rank's rows, gathered over the
    'data' group into the global batch (one all_gather per dtype); the
    backward is this rank's rows of each incoming gradient. Every data rank
    computes the same loss from the same gathered values, so each keeps the
    gradient of its own rows (``torch.distributed.nn.functional.all_gather``
    would sum the ranks' gradients: dp times too much)."""

    @staticmethod
    def forward(ctx, group, index: int, *tensors):
        n = tensors[0].shape[0]
        ctx.start, ctx.n = index * n, n
        out = [None] * len(tensors)
        by_dtype: dict = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([tensors[i].reshape(n, -1) for i in idx], dim=1)
            cols = _all_gather_rows(flat, group).split([tensors[i][0].numel() for i in idx], 1)
            for i, c in zip(idx, cols):
                out[i] = c.reshape((-1,) + tuple(tensors[i].shape[1:])).clone()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *(None if g is None else g.narrow(0, ctx.start, ctx.n)
                              for g in grads))


def gather_rows(tensors, mesh: Mesh2D) -> tuple:
    """``tensors`` (each with this rank's rows in dim 0, the same count)
    over the global batch, differentiable (:class:`_GatherRows`); the
    tensors themselves where the mesh has one data rank."""
    tensors = tuple(tensors)
    if mesh.data_group is None:
        return tensors
    return _GatherRows.apply(mesh.data_group, mesh.data_index, *tensors)


@torch.no_grad()
def sum_gradients(model: torch.nn.Module, mesh: Mesh2D) -> None:
    """The 2-D mode's gradient reduction, in place: every ``.grad`` summed
    over 'data' (each data rank holds the gradient of its own rows of the
    global loss), then each replicated parameter's taken from model index 0
    of the data row. The mp ranks of a row compute those from the same rows
    and the same weights, but a card's backward adds with atomics in places
    (pooling and interpolation), so they can differ in the last bits; one
    copy keeps the replicas equal, as GSPMD computes a replicated gradient
    once. A sharded parameter's slice lives on one rank of the row."""
    named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    if mesh.data_group is not None:
        _flat_apply([p.grad for _, p in named],
                    lambda flat: dist.all_reduce(flat, group=mesh.data_group))
    if mesh.model_group is not None:
        sharded = getattr(model, "sharded", None)
        plan = {} if sharded is None else sharded.plan["params"]
        _flat_apply([p.grad for n, p in named if plan.get(n) is None],
                    lambda flat: dist.broadcast(flat, src=mesh.model_root,
                                                group=mesh.model_group))


class BatchRows(torch.Generator):
    """A ``torch.Generator`` whose draws of a batch-leading shape
    (:func:`batch_draw`: the flip mask, dropout and drop-connect masks) are
    made at the global batch's size and cut to this rank's rows, so that
    each rank of the 2-D mode draws its rows of what one process draws for
    the global batch. ``rows`` = (global n, start, stop)."""

    rows: tuple = (0, 0, 0)


def batch_rows(generator: Optional[torch.Generator], n: int, rows: slice):
    """A :class:`BatchRows` generator in ``generator``'s state for rows
    ``rows`` of a global batch of ``n`` (``generator`` itself where the rows
    are the whole batch or there is none); hand its state back to
    ``generator`` after the draws."""
    if generator is None or (rows.start == 0 and rows.stop == n):
        return generator
    out = BatchRows(device=generator.device)
    out.set_state(generator.get_state())
    out.rows = (n, rows.start, rows.stop)
    return out


def batch_draw(draw: Callable, shape, generator: torch.Generator, **kwargs) -> torch.Tensor:
    """``draw(shape, generator=generator, device=generator.device,
    **kwargs)`` for a batch-leading ``shape``; from a :class:`BatchRows`
    generator, drawn for the global batch and cut to this rank's rows."""
    shape = tuple(shape)
    rows = getattr(generator, "rows", None)
    if rows is None:
        return draw(shape, generator=generator, device=generator.device, **kwargs)
    n, start, stop = rows
    if shape[0] != stop - start:
        raise ValueError(f"a draw of {shape[0]} rows from a generator of rows {start}:{stop}")
    return draw((n,) + shape[1:], generator=generator, device=generator.device,
                **kwargs)[start:stop]


def gspmd_train_step(step_fn: Callable, mesh: Mesh2D, state, min_size: int = 1 << 16) -> Callable:
    """The 2-D mode's step (mesh.py:178-195): ``step_fn`` built by
    ``make_train_step`` or ``make_normal_train_step`` with ``mesh`` (global
    sum_real/sum_fake), on ``state`` sharded in place by
    :func:`shard_state` at ``min_size``, with its BatchNorms synced over
    'data'. Call it with this rank's rows of the global batch
    (``mesh.rows(n)``); the metrics and ``cls_out`` it returns are the
    global batch's, on every rank."""
    sync_batchnorm(state.model, mesh.data_group)
    sharded = shard_state(state.model, state.opt_state, mesh, min_size)
    if sharded is None:
        return step_fn

    def step(*args, **kwargs):
        try:
            out = step_fn(*args, **kwargs)
        finally:
            sharded.release()
        broadcast_buffers(state.model, mesh)
        return out

    return step


@torch.no_grad()
def broadcast_buffers(model: torch.nn.Module, mesh: Mesh2D) -> None:
    """Every buffer (the BatchNorm statistics) from model index 0 of the data
    row, in place: the mp ranks of a row compute them from the same rows,
    but a card's kernels need not round alike from run to run, and one copy
    keeps the replicas equal, as GSPMD computes them once."""
    if mesh.model_group is not None:
        buffers = sorted(model.buffers(), key=lambda b: str(b.dtype))  # one bucket per dtype
        _flat_apply(buffers,
                    lambda flat: dist.broadcast(flat, src=mesh.model_root, group=mesh.model_group))
