"""The device the port runs on, named by the caller.

Every entry point takes a `device`; None means "cuda".  Nothing here
picks a device for the caller or falls back to the CPU when CUDA is
missing: a CUDA device without a card raises.  A CPU device is for
tests and runs the plain PyTorch version of every kernel.

The batch entry points (compress_images, compress_batch) also take a
sequence of devices, a data-parallel mesh (resolve_mesh), and spread a
node's cards by themselves when the caller names none.

Importing this module turns TF32 off for float32 matmuls and cuDNN
convolutions.  The SSIM search compares scores right at a threshold, and
TF32 keeps about three decimal digits, so every float32 product runs in
full float32.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Sequence, Tuple, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[None, str, torch.device]
MeshLike = Union[DeviceLike, Sequence[Union[str, torch.device]]]


_constants: Dict[Tuple[str, str], torch.Tensor] = {}
_constants_lock = threading.Lock()


def constant_on(name: str, make: Callable, device) -> torch.Tensor:
    """make()'s host array (the same at every call) as a tensor on
    `device`, uploaded once per (name, device) and kept: the small tables
    every call reads (the DCT matrices, the quality tables), whose copy
    from pageable host memory would otherwise wait at every call for the
    work queued on the stream.  Worker threads call it; a concurrent
    duplicate upload is harmless."""
    key = (name, str(device))
    with _constants_lock:
        got = _constants.get(key)
    if got is None:
        got = torch.tensor(make()).to(device)
        with _constants_lock:
            got = _constants.setdefault(key, got)
    return got


def require_cuda() -> None:
    """Raise unless PyTorch sees a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "fennec: no CUDA device (torch.cuda.is_available() is False); "
            "pass device='cpu' explicitly to run the plain versions")


def _is_sequence(device) -> bool:
    return isinstance(device, (list, tuple))


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch.device for a caller's `device` argument (None → cuda).
    A sequence of devices (a mesh) raises ValueError: only the batch
    entry points take one (resolve_mesh)."""
    if _is_sequence(device):
        raise ValueError(f"fennec: this entry point runs on one device, "
                         f"got {list(device)}; only compress_images and "
                         f"compress_batch take a sequence of devices")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"fennec: unsupported device {dev}")
    return dev


def _resolve_card(dev: torch.device) -> torch.device:
    """A CUDA device of a mesh with its index: a bare "cuda" is the
    current card; a card that does not exist raises."""
    require_cuda()
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"fennec: {dev} does not exist; PyTorch sees "
                         f"{torch.cuda.device_count()} card(s)")
    return torch.device("cuda", index)


def resolve_mesh(device: MeshLike = None):
    """The DataMesh a batch entry point spreads its chunks over, or None
    for one device (parallel/batched.data_mesh's rule; JAX
    parallel/batched.py:35):

      - a sequence of devices is always a mesh, repeats included (each
        entry a shard of its own); its CUDA entries must exist;
      - None or a bare "cuda" is a mesh over every visible card when
        there are two or more, unless FENNEC_MESH=0;
      - one named device ("cuda:k", "cpu") and the CPU are None.

    FENNEC_MESH=1 forces nothing more: the JAX package uses it to shard
    over the virtual devices of its CPU backend, and PyTorch has none."""
    from .parallel.mesh import DataMesh, visible_cards

    if _is_sequence(device):
        devs = [torch.device(d) for d in device]
        mesh = DataMesh(tuple(devs))
        if mesh.devices[0].type == "cuda":
            mesh = DataMesh(tuple(_resolve_card(d) for d in devs))
        return mesh
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return None
    if os.environ.get("FENNEC_MESH", "") == "0":
        return None
    cards = visible_cards()
    return DataMesh(tuple(cards)) if len(cards) >= 2 else None


def mesh_or_one(device: MeshLike = None):
    """resolve_mesh(device), or a mesh of the one resolved device (a
    card with its index)."""
    from .parallel.mesh import DataMesh

    mesh = resolve_mesh(device)
    if mesh is None:
        dev = resolve(device)
        mesh = DataMesh((_resolve_card(dev) if dev.type == "cuda" else dev,))
    return mesh
