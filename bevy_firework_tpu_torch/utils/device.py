"""The device rule of the port's entry points: they run on the card unless the
caller asks for the CPU (`device="cpu"`), and a call for the card on a
machine without one raises instead of running on the CPU."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """`device` as a torch.device, a CUDA device with its index (the current
    one where none is given, as tensors made there report it); raises
    RuntimeError for a CUDA device when this process has none."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for device={device!r}: pass device='cpu' to run the plain "
                               "PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device` without waiting for the card: staged in
    pinned memory and copied non-blocking on the current stream (PyTorch's
    caching host allocator keeps the staging block until the copy lands,
    so nothing rewrites it early). On the CPU the tensor itself."""
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
