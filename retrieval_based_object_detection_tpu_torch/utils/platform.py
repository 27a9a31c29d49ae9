"""Device resolution with no fallback.

Entry points of the port take ``device`` (default ``"cuda"``). Asking for
CUDA on a machine without a usable GPU raises; nothing silently moves work
to the CPU. The CPU runs only when a caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no GPU
    is available, or names a device type the port does not run on."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: "
                         "expected 'cuda[:N]' or 'cpu'")
    return dev
