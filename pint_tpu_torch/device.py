"""Device selection for the port's entry points.

The port runs on CUDA by default. A caller that wants the CPU says so with
``device="cpu"`` (the tests do); without a GPU and without that request an
entry point raises instead of quietly continuing on the CPU.
"""

from __future__ import annotations

import torch

DTYPE = torch.float64


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raising when absent); otherwise
    the named device, checked to exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain-torch path on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not available")
        if dev.index is None:  # name the card, as tensors on it report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def require_f64(where: str, **groups) -> None:
    """Raise TypeError naming every tensor in `groups` (dicts of tensors or
    DD pairs) that is not float64: a float32 value anywhere in the forward
    chain silently drops the low word of every double-double after it."""
    bad = []
    for group, values in groups.items():
        for name, v in values.items():
            parts = v if isinstance(v, tuple) else (v,)
            if any(isinstance(t, torch.Tensor) and t.dtype != DTYPE for t in parts):
                bad.append(f"{group}[{name!r}]: {[t.dtype for t in parts]}")
    if bad:
        raise TypeError(f"{where} needs float64 throughout; got " + "; ".join(bad))
