"""The (data x db) grid of ranks the sharded engines run on.

Port of ``kmer_id_tpu/parallel/mesh.py``.  JAX's mesh is one process
holding every device; here it is a grid of ``torch.distributed`` ranks, one
per device, laid out as ``make_mesh`` reshapes its devices: rank ``r`` sits
at data index ``r // dbp`` and db index ``r % dbp``.

* ``data`` — read batches shard across this axis: data shard ``d`` owns the
  batch rows ``[d * B / dp, (d + 1) * B / dp)``;
* ``db`` — the probe DB shards across this axis (by L1 bucket range for the
  fingerprint engine, by sorted-key range for the legacy engine).

The collectives the engines need are methods of :class:`Grid`, each over
the ranks of one axis: ``all_gather_db``/``psum_db`` over the ranks with
this rank's data index, ``psum_data``/``all_gather_data`` over the ranks
with its db index, and ``barrier`` over all.  An axis of one rank needs no
process group, and its collectives are identities (so a 1 x 1 grid needs
none at all).

A group's backend decides where its tensors go: an NCCL group takes device
tensors as they are; a gloo group gets CPU tensors, so the grid copies a
CUDA tensor to the host before a gloo collective and the result back to
its device after.  The grid chooses this when it is built, from the
default group's backend, not as a recovery from an error; it is what lets
several ranks share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from kmer_id_tpu_torch.io.batch import Batch


@dataclass
class Grid:
    """One rank's view of the grid: its place, its device, the backend of
    its process groups (None without any) and the groups of its two axes
    (None for an axis of one rank)."""

    rank: int
    world: int
    dp: int
    dbp: int
    device: torch.device
    backend: str | None = None
    db_group: object = None  # the ranks with this rank's data index
    data_group: object = None  # the ranks with this rank's db index

    @property
    def data_index(self) -> int:
        return self.rank // self.dbp

    @property
    def db_index(self) -> int:
        return self.rank % self.dbp

    @property
    def via_host(self) -> bool:
        """True when collectives take host copies of CUDA tensors (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _out(self, t):
        return t.cpu() if self.via_host else t

    def _back(self, t):
        return t.to(self.device) if self.via_host else t

    def _psum(self, t, group, n: int):
        if n == 1:
            return t
        x = self._out(t).clone()
        dist.all_reduce(x, group=group)
        return self._back(x)

    def _gather(self, t, group, n: int):
        if n == 1:
            return t[None]
        x = self._out(t).contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return self._back(torch.stack(parts))

    def psum_db(self, t):
        """Sum of ``t`` over the db axis (integer tensors)."""
        return self._psum(t, self.db_group, self.dbp)

    def psum_data(self, t):
        """Sum of ``t`` over the data axis (integer tensors)."""
        return self._psum(t, self.data_group, self.dp)

    def all_gather_db(self, t):
        """[dbp, *t.shape]: every db member's ``t``, in db order."""
        return self._gather(t, self.db_group, self.dbp)

    def all_gather_data(self, t):
        """[dp, *t.shape]: every data member's ``t``, in data order."""
        return self._gather(t, self.data_group, self.dp)

    def barrier(self) -> None:
        """Every rank of the grid reaches this point (an all-reduce of one
        word over the default group)."""
        if self.world > 1:
            x = torch.ones(1, dtype=torch.int32,
                           device="cpu" if self.backend == "gloo" else self.device)
            dist.all_reduce(x)


def make_mesh(data: int = 0, db: int = 1, device=None) -> Grid:
    """This rank's :class:`Grid` of ``data`` x ``db`` ranks; ``data=0``
    means all the ranks there are over ``db``.  Without an initialized
    process group the world is this one process.  Refuses, as JAX's
    ``make_mesh`` does, ``db < 1`` and a grid larger than the ranks there
    are, and also a grid smaller: a rank outside it would have no rows.
    Every rank creates every axis group, in the same order, as
    ``torch.distributed.new_group`` requires.  ``device`` defaults to the
    current CUDA device under NCCL, else the CPU."""
    if db < 1:
        raise ValueError("db axis must be >= 1")
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    if data <= 0:
        data = world // db
    need = data * db
    if need > world or data < 1:
        raise ValueError(f"mesh {max(data, 1)}x{db} needs {max(need, db)} devices, have {world}")
    if need < world:
        raise ValueError(f"mesh {data}x{db} leaves {world - need} of {world} ranks outside it")
    backend = dist.get_backend() if up else None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    grid = Grid(rank, world, data, db, torch.device(device), backend)
    if world > 1:
        for d in range(data):  # db axes: the ranks of one data index
            g = dist.new_group([d * db + k for k in range(db)]) if db > 1 else None
            if d == grid.data_index:
                grid.db_group = g
        for k in range(db):  # data axes: the ranks of one db index
            g = dist.new_group([d * db + k for d in range(data)]) if data > 1 else None
            if k == grid.db_index:
                grid.data_group = g
    return grid


def slice_batch(batch: Batch, r0: int, r1: int, width: int) -> Batch:
    """Rows ``[r0, r1)`` of a Batch: its code plane and lengths, and its
    packed words with the exception list filtered to those rows and
    re-based (its entries are flat ``row * width + pos`` indices of the
    whole batch; ``width`` is the rows' width, the code plane's).  Metas
    and ``n_rows`` stay the whole batch's."""
    packed = exc = None
    if batch.packed is not None:
        packed = batch.packed[r0:r1]
        e = np.asarray(batch.exc)
        keep = e[(e >= r0 * width) & (e < r1 * width)] - r0 * width
        exc = np.full_like(e, -1)
        exc[: len(keep)] = keep
    codes = batch.codes[r0:r1] if batch.codes is not None else None
    return Batch(codes=codes, lengths=batch.lengths[r0:r1], metas=batch.metas,
                 n_rows=batch.n_rows, packed=packed, exc=exc)
