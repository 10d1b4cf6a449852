"""The device mesh: which devices a batch, or one image's rows, are
spread over.

Counterpart of fennec_tpu/parallel/mesh.py.  The JAX package builds a
jax.sharding.Mesh and lets shard_map place a chunk's rows on its chips;
here a DataMesh is the list of torch devices that one batch's chunks are
split over (parallel/batched.shard_data_call), one contiguous range of
rows per entry, each entry run on a CUDA stream of its own and each
device by a thread of its own.  Images are independent, so no collective
is needed.

A DataSpatialMesh (data_spatial_mesh) is the 2-D ("data", "spatial")
mesh: a batch over its data rows, and one image's rows over the devices
of a data row, in contiguous bands (shard_bands, the role of JAX's
batch_sharding(mesh, spatial=True)).  The JAX package lets XLA insert
the halo exchanges and reductions of a row-sharded program;
parallel/batched.quality_search_spatial_sharded and
batched_ssim_sharded(spatial=True) do that work by hand, band by band.

An explicit list may name one device more than once: each entry is then
a shard of its own (its own stream and share of the device's memory),
and the device's thread runs its shards in turn.  That is how the CPU
tests run a mesh (["cpu"] * 3, or "cpu:0", "cpu:1", ... to stand for
cards with a thread each) and how a machine with one card runs one
(["cuda:0", "cuda:0"]).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D ("data",) mesh: `devices[k]` runs shard k of every chunk."""

    devices: Tuple[torch.device, ...]
    axis_names: ClassVar[Tuple[str, ...]] = ("data",)

    def __post_init__(self) -> None:
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("fennec: a mesh needs at least one device")
        if len({d.type for d in devs}) != 1 or devs[0].type not in (
                "cpu", "cuda"):
            raise ValueError(f"fennec: a mesh takes CUDA devices or CPU "
                             f"devices, not {[str(d) for d in devs]}")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """The devices in first-seen order, each once."""
        return list(dict.fromkeys(self.devices))


@dataclasses.dataclass(frozen=True)
class DataSpatialMesh:
    """A 2-D ("data", "spatial") mesh: `devices[i][j]` holds band j of
    the rows of the images of data row i."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: ClassVar[Tuple[str, ...]] = ("data", "spatial")

    def __post_init__(self) -> None:
        rows = tuple(DataMesh(tuple(r)).devices for r in self.devices)
        if not rows or len({len(r) for r in rows}) != 1:
            raise ValueError("fennec: a data x spatial mesh needs rows of "
                             "one length")
        DataMesh(sum(rows, ()))  # one kind of device
        object.__setattr__(self, "devices", rows)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "spatial": len(self.devices[0])}

    def data_axis(self) -> DataMesh:
        """The devices of the first spatial column: what a function that
        splits only the batch runs on (JAX replicates it over the
        spatial axis)."""
        return DataMesh(tuple(row[0] for row in self.devices))


Mesh = Union[DataMesh, DataSpatialMesh]


def visible_cards() -> List[torch.device]:
    """Every CUDA device PyTorch sees, cuda:0 first."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the given shape over `devices` (default: the visible
    cards), the first devices row by row: a ("data",) DataMesh or a
    ("data", "spatial") DataSpatialMesh."""
    names, sizes = tuple(axis_names), tuple(int(n) for n in axis_sizes)
    if names not in (("data",), ("data", "spatial")) or len(sizes) != len(
            names):
        raise ValueError(f"fennec: a mesh is ('data',) or ('data', "
                         f"'spatial'), got {sizes} over {names}")
    devs = list(devices) if devices is not None else visible_cards()
    n = math.prod(sizes)
    if n > len(devs):
        raise ValueError(f"fennec: mesh needs {n} devices, have {len(devs)}")
    if len(sizes) == 1:
        return DataMesh(tuple(devs[:n]))
    per = sizes[1]
    return DataSpatialMesh(tuple(tuple(devs[i * per:(i + 1) * per])
                                 for i in range(sizes[0])))


def data_mesh(n_devices: Optional[int] = None) -> DataMesh:
    """1-D data-parallel mesh over n visible cards (default: all)."""
    devs = visible_cards()
    n = n_devices if n_devices is not None else len(devs)
    return make_mesh((n,), ("data",), devs)


def data_spatial_mesh(n_devices: int, spatial: int = 2,
                      devices: Optional[Sequence] = None) -> DataSpatialMesh:
    """2-D mesh of n_devices (JAX :32): the batch over "data", one
    image's rows over "spatial" (spatial devices a data row), over
    `devices` (default: the visible cards; a list may repeat a device)."""
    if spatial < 1 or n_devices % spatial != 0:
        # Silently degrading to spatial=1 would skip the row split the
        # caller asked for (and run out of memory on the images it is for).
        raise ValueError(
            f"fennec: spatial={spatial} must divide n_devices={n_devices}")
    return make_mesh((n_devices // spatial, spatial), ("data", "spatial"),
                     devices)


def shard_bands(h: int, mesh: DataSpatialMesh) -> List[Tuple[int, int]]:
    """(start, stop) of each spatial shard's rows of an image of h rows:
    contiguous bands of h / spatial rows, in order."""
    n_sp = mesh.shape["spatial"]
    if h % n_sp:
        raise ValueError(f"fennec: {h} rows do not split into {n_sp} "
                         f"bands")
    per = h // n_sp
    return [(k * per, (k + 1) * per) for k in range(n_sp)]


def shard_rows(b: int, mesh: DataMesh) -> List[Tuple[int, int]]:
    """(start, stop) of each shard's rows of a batch of b: contiguous, in
    input order, as even as possible (the first b % size shards hold one
    row more).  A shard is empty when b < mesh.size."""
    per, extra = divmod(b, mesh.size)
    out, start = [], 0
    for k in range(mesh.size):
        stop = start + per + (1 if k < extra else 0)
        out.append((start, stop))
        start = stop
    return out
