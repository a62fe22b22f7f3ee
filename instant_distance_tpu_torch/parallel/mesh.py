"""Device meshes and the cross-shard merge (port of
``instant_distance_tpu/parallel/mesh.py``).

A :class:`Mesh` is an ordered list of torch devices, one per shard (or
per batch slice) that this process holds, and a place in a
``torch.distributed`` process group: rank r of W holds the global shards
``r * L .. r * L + L - 1`` of ``W * L``, process-major as the JAX
package's global device order is.  A list may name one device more than
once (``["cpu"] * 8``, four shards on ``cuda:0``): several shards then
share that device, as the JAX package's virtual CPU devices share a
host.

Every sharded index merges its shards' candidates with
:func:`gather_merge`: the per-shard [B, ef] results side by side, shard
major, an ``all_gather`` across ranks, then one two-key sort by
(distance, id).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.sort import sort2


class Mesh:
    """This process's devices (``devices``, in shard order), its
    ``rank`` in a group of ``world`` processes, and whether results are
    gathered across that group (``distributed``)."""

    def __init__(self, devices: Sequence, rank: int = 0, world: int = 1,
                 distributed: bool = False):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.rank, self.world = int(rank), int(world)
        self.distributed = bool(distributed)

    @property
    def size(self) -> int:
        """Global shard count: every rank holds as many as this one."""
        return self.world * len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where results are returned."""
        return self.devices[0]

    def shard_ids(self) -> range:
        """Global indices of this process's shards."""
        local = len(self.devices)
        return range(self.rank * local, (self.rank + 1) * local)


def _cuda_devices():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless asked for the "
            "CPU (pass devices=['cpu'] * n)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_mesh(n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over this process's ``devices`` (default: every visible
    CUDA card; without one it raises), the first ``n_devices`` of them
    when given."""
    devices = _cuda_devices() if devices is None else list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices)


def distributed_mesh(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> Mesh:
    """A mesh across processes: joins the ``torch.distributed`` process
    group once (NCCL for CUDA devices, gloo when ``devices`` are all
    CPU) and returns this process's part of the global mesh.

    ``coordinator_address`` (``"host:port"`` or a URL such as
    ``"tcp://127.0.0.1:29500"``), ``num_processes`` and ``process_id``
    go to ``init_process_group``; with all three None it reads torchrun's
    environment (``env://``).  Every process must hold as many devices
    as the others.  Initialization errors propagate: a failed join never
    degrades to a one-process mesh.
    """
    import torch.distributed as dist

    devices = _cuda_devices() if devices is None else list(devices)
    devices = [torch.device(d) for d in devices]
    if not dist.is_initialized():
        backend = ("gloo" if all(d.type == "cpu" for d in devices)
                   else "nccl")
        if backend == "nccl":
            torch.cuda.set_device(devices[0])
        if (coordinator_address, num_processes, process_id) == (None,) * 3:
            dist.init_process_group(backend, init_method="env://")
        else:
            url = coordinator_address
            if url is not None and "://" not in url:
                url = f"tcp://{url}"
            dist.init_process_group(backend, init_method=url,
                                    world_size=num_processes,
                                    rank=process_id)
    return Mesh(devices, rank=dist.get_rank(), world=dist.get_world_size(),
                distributed=True)


def all_gather_rows(mesh: Mesh, x, dim: int = 0):
    """``x`` of every rank, concatenated along ``dim`` in rank order (``x``
    itself on a mesh that is not distributed)."""
    if not mesh.distributed:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim)


def all_sum(mesh: Mesh, value: int) -> int:
    """``value`` summed over the ranks of a distributed mesh."""
    if not mesh.distributed:
        return int(value)
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.first)
    dist.all_reduce(t)
    return int(t.item())


def gather_merge(mesh: Mesh, d, g, k: int):
    """Merge per-shard results into the global top ``k``.

    ``d``/``g``: this process's shards' (dists [B, ef], global ids
    [B, ef]) in shard order, (inf, -1) padded.  They are set side by side
    shard-major on ``mesh.first``, gathered from every rank in rank order,
    and sorted by (distance, id), the JAX package's
    ``lax.sort(num_keys=2)`` over the all-gathered candidates.  Returns
    (dists [B, k], ids [B, k]) on ``mesh.first``; every rank gets the
    same."""
    dev = mesh.first
    cd = torch.cat([x.to(dev, torch.float32) for x in d], 1)
    cg = torch.cat([x.to(dev, torch.int32) for x in g], 1)
    cd, cg = all_gather_rows(mesh, cd, 1), all_gather_rows(mesh, cg, 1)
    sd, sg = sort2(cd, cg)
    return sd[:, :k], sg[:, :k]
