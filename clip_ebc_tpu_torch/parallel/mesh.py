"""Data-parallel process group: counterpart of ``clip_ebc_tpu/parallel/mesh.py``.

The JAX package runs one process per host over a global device mesh, the
batch sharded on its ``data`` axis and the state replicated; GSPMD
inserts every collective. The port runs one process per device (torch's
``DistributedDataParallel`` idiom): rank r drives ``cuda:{r % devices}``
(or the CPU), holds a full replica of the model, takes its own shard of
the global batch from the loader, and the collectives are explicit:
DDP's gradient all-reduce, the BatchNorm statistics
(``models/blocks.py``), the loss terms' reduction (:func:`reduce_metrics`)
and the sliding-window gather (:func:`gather_rows`).

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo, the CPU
backend (and the one that lets two ranks share one card), has no
``all_gather`` for CUDA tensors. Without an initialized group every helper
is the one-process identity, so the same code runs alone.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Union

import torch
import torch.distributed as dist

from ..utils.platform import resolve_device

DATA_AXIS = "data"  # the name models take as ``axis_name`` to sync BatchNorm


def rank_device(device: Optional[Union[str, torch.device]] = None,
                rank: Optional[int] = None) -> torch.device:
    """The device of ``rank`` (default: this process's): ``cuda:{rank %
    device count}`` for a CUDA device without an index, else ``device``
    itself (``resolve_device``: no quiet move to the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    r = get_rank() if rank is None else rank
    return torch.device("cuda", r % torch.cuda.device_count())


def init_process_group(init_method: str, world_size: int, rank: int, backend: str,
                       device: Optional[Union[str, torch.device]] = None) -> None:
    """Join a group of ``world_size`` processes (one included) at
    ``init_method`` (``tcp://host:port`` or ``file://path``). Under NCCL
    the rank's device becomes current and is bound to the group first:
    NCCL refuses two ranks on one device, and that error is raised."""
    kwargs = {}
    if backend == "nccl":
        dev = rank_device(device or "cuda", rank)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)


def initialize_distributed(coordinator: Optional[str], num_processes: Optional[int],
                           process_id: int = 0, backend: Optional[str] = None,
                           device: Union[str, torch.device] = "cuda") -> None:
    """The trainer's multi-process init (the JAX ``initialize_distributed``):
    a no-op for one process; else process ``process_id`` of
    ``num_processes`` joins the group at ``coordinator`` (``host:port``,
    or a URL such as ``file:///path``) on ``backend`` (default: NCCL for a
    CUDA ``device``, gloo for the CPU as in the JAX package; ``"gloo"`` lets
    ranks share a card). Raises ``ValueError`` for flags that name no
    process of a group."""
    num_processes = 1 if num_processes is None else num_processes
    if num_processes < 1:
        raise ValueError(f"the process count (--num_hosts) must be >= 1, got {num_processes}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id (--host_id) {process_id} is outside "
                         f"[0, {num_processes})")
    if num_processes == 1:
        return
    if not coordinator:
        raise ValueError("a multi-process run needs --coordinator host:port")
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    init_process_group(init_method, num_processes, process_id, backend, device)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if is_distributed():
        dist.destroy_process_group()


def get_world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def get_rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def is_primary() -> bool:
    """Rank 0 (or a process without a group): the one that writes files."""
    return get_rank() == 0


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier()


def shard_rows(n: int, rank: Optional[int] = None, world: Optional[int] = None) -> slice:
    """Rank ``rank``'s rows of ``n``: ``n`` rounded up to a multiple of the
    world gives every rank ``ceil(n / world)`` slots, in rank order; the
    slots past ``n`` hold nothing (the last ranks may get fewer rows)."""
    world = get_world_size() if world is None else world
    rank = get_rank() if rank is None else rank
    per = -(-n // world)
    return slice(min(rank * per, n), min((rank + 1) * per, n))


def shard_batch(batch, rank: Optional[int] = None, world: Optional[int] = None):
    """Rank ``rank``'s equal slice of a global batch (a tensor, or a
    dataclass of tensors such as ``data.loader.Batch``), whose leading
    size the world must divide."""
    world = get_world_size() if world is None else world
    rank = get_rank() if rank is None else rank
    tensors = batch if isinstance(batch, torch.Tensor) else vars(batch)

    def take(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % world:
            raise ValueError(f"global batch {x.shape[0]} is not divisible by the "
                             f"{world} ranks")
        per = x.shape[0] // world
        return x[rank * per:(rank + 1) * per]

    if isinstance(tensors, torch.Tensor):
        return take(tensors)
    return type(batch)(**{k: take(v) for k, v in tensors.items()})


def replicate(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Broadcast ``x`` from rank ``src`` into every rank's ``x`` (in place)."""
    if get_world_size() > 1:
        dist.broadcast(x, src)
    return x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the ranks, in place; the tensor is returned."""
    if get_world_size() > 1:
        dist.all_reduce(x)
    return x


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, and its gradient: the sum of the ranks'
    gradients (each rank's sum feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum_autograd(x: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`all_reduce_sum` (out of place)."""
    return _AllReduceSum.apply(x) if get_world_size() > 1 else x


def gather_rows(local: torch.Tensor, rows: slice, n: int) -> torch.Tensor:
    """The ``(n, ...)`` fp32 tensor whose rows ``rows`` each rank computed
    (``local``, ``rows.stop - rows.start`` rows; the slices cover ``[0,
    n)`` once): each rank writes into a zero buffer of the full size and
    the buffers are summed (gloo has no ``all_gather`` of CUDA tensors)."""
    buf = torch.zeros((n,) + tuple(local.shape[1:]), dtype=torch.float32, device=local.device)
    buf[rows] = local.float()
    return all_reduce_sum(buf)


def reduce_metrics(metrics: Dict[str, torch.Tensor], summed: Iterable[str] = ()
                   ) -> Dict[str, float]:
    """Rank-local scalar metrics -> global floats with one all-reduce: the
    keys in ``summed`` (terms summed over the batch) add up, the others
    (means over equal shards) are averaged."""
    if not metrics:
        return {}
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    world = get_world_size()
    all_reduce_sum(vals)
    summed = set(summed)
    out = vals.tolist()
    return {k: v if k in summed else v / world for k, v in zip(keys, out)}
