"""Devices and processes (counterpart of virnet_tpu/train/mesh.py).

The reference's only parallelism is single-node data parallelism with NCCL
DDP (train_denoising_syn.py:35-39, 70-71, 126-139).  The JAX package runs
one process over a 1-D 'data' mesh; this port follows PyTorch's idiom:
one process per card, joined by a ``torch.distributed`` process group
(NCCL on the card, gloo on the CPU), each holding a full replica of the
parameters and its rows of every global batch.  The trainers all-reduce
the gradients themselves (train/loop_sisr.py, train/loop_denoise.py), so
the parameters keep their plain names and a checkpoint loads at any world
size.

A ``Mesh`` lists this process's devices and carries the process group's
``world`` and ``rank`` (1 and 0 without one).  A device may repeat
(``[cuda:0] * 4``, ``[cpu] * 4``): the counterpart of the JAX virtual CPU
mesh, and the way an n-way plan runs on one card (eval/spatial.py,
eval/engine.Restorer).
"""

from __future__ import annotations

import datetime
import logging
from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   timeout_s: float = 300.0) -> int:
    """Join the process group and return its size (the reference's
    MASTER_ADDR / NCCL port plumbing, train_denoising_syn.py:35-39).

    ``coordinator_address`` ('host:port') rendezvouses over
    ``tcp://<coordinator_address>`` with ``num_processes`` and
    ``process_id``; without it, torchrun's variables (``env://``:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  ``backend`` defaults to
    NCCL when a card is visible, else gloo; two ranks on one card need
    gloo (NCCL refuses them).  With nothing to join (no address and no
    WORLD_SIZE) it is a no-op.  A failed join raises when more than one
    process was asked for (a typo'd address must not degrade to a
    single-process run) and is logged at WARNING otherwise.
    """
    import os

    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator_address is None and "WORLD_SIZE" not in os.environ:
        return 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator_address is not None:
        kw.update(init_method=f"tcp://{coordinator_address}",
                  world_size=1 if num_processes is None else num_processes,
                  rank=0 if process_id is None else process_id)
    else:
        kw.update(init_method="env://")
    try:
        dist.init_process_group(**kw)
    except (ValueError, RuntimeError) as exc:
        if num_processes is not None and num_processes > 1:
            raise RuntimeError(
                f"multi-process init failed for coordinator "
                f"{coordinator_address!r} ({num_processes} processes, "
                f"process_id={process_id}, backend {backend}): {exc}"
            ) from exc
        logging.getLogger("virnet_tpu_torch").warning(
            "torch.distributed init unavailable (%s); continuing "
            "single-process", exc)
        return 1
    return dist.get_world_size()


class Mesh:
    """This process's devices, and its place in the process group."""

    def __init__(self, devices: Sequence, world: int = 1, rank: int = 0,
                 grouped: bool = False):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.world = int(world)
        self.rank = int(rank)
        # whether the collectives run: a process group joins this process
        # to others (a group of one process counts)
        self.grouped = bool(grouped)

    @property
    def size(self) -> int:
        """The number of devices (repeats counted)."""
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """The devices without repeats, in order."""
        return list(dict.fromkeys(self.devices))

    # ------------------------------------------------------- global batch

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``; raises when ``n``
        does not divide by the world size."""
        if n % self.world:
            raise ValueError(f"batch_size={n} must be divisible by the "
                             f"world size ({self.world} processes)")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_batch(self, batch, n: Optional[int] = None):
        """This rank's rows of every array of a global batch (an array, or
        a tuple, list or dict of them, nested); ``n`` defaults to the
        leading size of the first array."""
        if n is None:
            n = _first(batch).shape[0]
        return map_rows(batch, self.rows(n))

    # -------------------------------------------------------- collectives

    def replicate(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite each tensor in place with rank 0's."""
        if self.grouped:
            for t in tensors:
                dist.broadcast(t.data, src=0)

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace each tensor in place by its mean over the ranks, as one
        flat buffer in the given order (gloo has no average: a sum
        divided by the world size)."""
        if not self.grouped or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat /= self.world
        parts = flat.split([t.numel() for t in tensors])
        torch._foreach_copy_(list(tensors),
                             [v.view_as(t) for v, t in zip(parts, tensors)])

    def barrier(self) -> None:
        if self.grouped:
            dist.barrier()


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible card), with the
    process group's world size and rank when there is one."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device: pass devices=[...] (e.g. "
                               "['cpu'] * 4) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    if dist.is_initialized():
        return Mesh(devices, dist.get_world_size(), dist.get_rank(), True)
    return Mesh(devices)


def _first(tree):
    if isinstance(tree, (tuple, list)):
        return _first(tree[0])
    if isinstance(tree, dict):
        return _first(next(iter(tree.values())))
    return tree


def map_rows(tree, rows: slice):
    """``rows`` of the leading axis of every array of ``tree`` (an array,
    or a tuple, list, NamedTuple or dict of them, nested; None stays
    None)."""
    if isinstance(tree, tuple):
        out = [map_rows(t, rows) for t in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    if isinstance(tree, list):
        return [map_rows(t, rows) for t in tree]
    if isinstance(tree, dict):
        return {k: map_rows(v, rows) for k, v in tree.items()}
    return None if tree is None else tree[rows]
