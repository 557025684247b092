"""Device choice for the port: the backend pick of
ceph_tpu/common/device_policy.py, reduced to one rule.

Every entry point takes ``device`` and resolves it here: ``None`` means
``cuda``; a CUDA device without a card raises, so nothing silently runs
on the CPU.  ``device="cpu"`` is the caller's explicit request (the tests
make it) and selects the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch.device an entry point runs on (``cuda`` by default)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: want cuda or cpu")
    return dev


#: SM count per CUDA device index, read once
_SMS: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The SM count of `device` (the current device when it has no
    index), read once per device; the kernels size their grids by it."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def as_bytes_tensor(x, device: torch.device) -> torch.Tensor:
    """uint8 tensor on `device` from a tensor, numpy array or bytes."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise TypeError(f"expected uint8 bytes, got {x.dtype}")
        return x.to(device)
    if isinstance(x, (bytes, bytearray, memoryview)):
        x = np.frombuffer(x, dtype=np.uint8)
    arr = np.ascontiguousarray(x, dtype=np.uint8)
    if not arr.flags.writeable:  # torch.from_numpy wants a writable buffer
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def to_host(x) -> np.ndarray:
    """A codec's output (a uint8 tensor on its device) as a host numpy
    array: what the OSD stores, checksums and sends.  Numpy input passes
    through."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x, dtype=np.uint8)
