"""The batch mesh: one batch split over devices, one model replica a device.

Counterpart of ``pytorch_yolo_tpu/parallel/sharding.py``, with its design:
one controller process, the parameters replicated once a device, the batch
split along axis 0, the fixed-shape results gathered at the end.  JAX hands
the split to GSPMD; here the controller does it:

* :func:`shard_batch` cuts a batch into ``mesh.size`` equal shards, shard i
  on entry i's device;
* :func:`replicate_params` gives each distinct device one copy of a module;
  repeated entries share it;
* :func:`gather_batch` joins per-shard tensors on the mesh's first device.

No ``torch.distributed``, NCCL or process group: the JAX mesh's only
collectives, the gather and the whole-batch max of the dynamic int8 scale
(``models/darknet.py: _shared_scales``), are copies between devices in one
process.  A copy between two cards is torch's ``copy_``, which orders itself
against both devices' current streams (an event each way) whatever device
is current.

An entry may repeat, and each entry is one shard: a mesh of two entries of
``cuda:0`` runs the split on one card, as the JAX package's tests run theirs
on eight virtual CPU devices.  The CPU is an entry only where the caller
names it.

The JAX module's ``batch_sharding`` and ``replicated`` return
``NamedSharding`` objects, which mean nothing here; they are left out.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Sequence

import numpy as np
import torch

BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """A 1-D mesh over axis ``BATCH_AXIS``: one device an entry, one shard an
    entry."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _entry(device: "str | torch.device") -> torch.device:
    d = torch.device(device)
    if d.type == "cpu":
        return torch.device("cpu")
    if d.type != "cuda":
        raise ValueError(f"mesh entry {d}: the mesh takes cpu and cuda devices")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = d.index if d.index is not None else (torch.cuda.current_device() if count else 0)
    if index >= count:
        raise ValueError(f"mesh entry {d}: only {count} local CUDA device(s)")
    return torch.device("cuda", index)


def make_batch_mesh(devices: "Sequence[str | torch.device] | None" = None) -> BatchMesh:
    """1-D mesh over every local CUDA card, or over ``devices`` (an entry may
    repeat; the CPU only where named).  Raises where there is no card to
    take, and on an entry past ``torch.cuda.device_count()``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_batch_mesh() takes every local CUDA device and "
                               "torch.cuda.is_available() is False: name the devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = BatchMesh(tuple(_entry(d) for d in devices))
    if not mesh.size:
        raise ValueError("a mesh needs at least one device")
    return mesh


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``n`` (batch padding for even sharding)."""
    return ((n + m - 1) // m) * m


def shard_batch(x, mesh: BatchMesh) -> tuple[torch.Tensor, ...]:
    """A batch (numpy array or tensor) cut along axis 0 into ``mesh.size``
    equal shards, shard i contiguous on ``mesh.devices[i]``.

    The batch must divide the mesh size: callers pad with
    ``pad_to_multiple`` and drop the tail rows after the gather."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"batch {n} does not divide the mesh size {mesh.size}")
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return tuple(part.to(dev).contiguous()
                 for part, dev in zip(t.split(n // mesh.size), mesh.devices))


def replicate_params(module: torch.nn.Module, mesh: BatchMesh) -> tuple[torch.nn.Module, ...]:
    """``module`` on every entry of the mesh: one copy a distinct device,
    shared by that device's entries.  The first device's copy is ``module``
    itself, moved there (``Module.to`` moves in place)."""
    copies: dict[torch.device, torch.nn.Module] = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = (copy.deepcopy(module) if copies else module).to(dev)
    return tuple(copies[dev] for dev in mesh.devices)


def gather_batch(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Per-shard tensors joined along axis 0 on ``device`` (copies from other
    cards ``non_blocking``); one part is returned as it is."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device, non_blocking=True) for p in parts])
