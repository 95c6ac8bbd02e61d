"""Device policy of the port: CUDA unless the caller asks for the CPU.

There is no silent fallback. An entry point called with the default device
on a machine without a GPU raises; the CPU runs only when a caller (a test,
a CPU-only worker) passes ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def as_tensor(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """``x`` (a tensor, numpy array or sequence) as a ``dtype`` tensor on
    ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=dev, dtype=dtype)


def resolve(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Raises ``RuntimeError`` for a CUDA device when CUDA is absent, and
    ``ValueError`` for any device type other than ``cuda`` or ``cpu``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def upload(a, dev: torch.device) -> torch.Tensor:
    """The numpy array ``a`` as a tensor on ``dev``: on the card through
    pinned memory, a copy that does not wait for the stream's earlier
    work."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)
