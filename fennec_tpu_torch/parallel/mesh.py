"""The data-parallel mesh: which devices a batch is spread over.

Counterpart of fennec_tpu/parallel/mesh.py.  The JAX package builds a
jax.sharding.Mesh and lets shard_map place a chunk's rows on its chips;
here a DataMesh is the list of torch devices that one batch's chunks are
split over (parallel/batched.shard_data_call), one contiguous range of
rows per entry, each entry run by a thread of its own on a CUDA stream of
its own.  Images are independent, so no collective is needed.

An explicit list may name one device more than once: each entry is then
a shard of its own (its own thread, stream and share of the device's
memory).  That is how the CPU tests run a mesh (["cpu"] * 3) and how a
machine with one card runs one (["cuda:0", "cuda:0"]).

Only the 1-D ("data",) mesh is ported.  The JAX package's data×spatial
mesh (data_spatial_mesh), which splits one image's rows over chips, and
its NamedSharding helpers (batch_sharding, scalar_batch_sharding; here
shard_rows) are not.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, List, Optional, Sequence, Tuple

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


def visible_cards() -> List[torch.device]:
    """Every CUDA device PyTorch sees, cuda:0 first."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> DataMesh:
    """A mesh of the given shape over `devices` (default: the visible
    cards).  Only the 1-D ("data",) shape is ported."""
    if tuple(axis_names) != ("data",) or len(axis_sizes) != 1:
        raise ValueError(f"fennec: only a 1-D ('data',) mesh is ported, "
                         f"got {tuple(axis_sizes)} over {tuple(axis_names)}")
    devs = list(devices) if devices is not None else visible_cards()
    n = int(axis_sizes[0])
    if n > len(devs):
        raise ValueError(f"fennec: mesh needs {n} devices, have {len(devs)}")
    return DataMesh(tuple(devs[:n]))


def data_mesh(n_devices: Optional[int] = None) -> DataMesh:
    """1-D data-parallel mesh over n visible cards (default: all)."""
    devs = visible_cards()
    n = n_devices if n_devices is not None else len(devs)
    return make_mesh((n,), ("data",), devs)


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
