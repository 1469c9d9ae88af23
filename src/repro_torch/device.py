"""Device policy of the port: the card by default, the CPU only when asked.

Every entry point (``Session``, ``Executor``, ``BlockTable.from_numpy``,
``tpch_catalog``) takes ``device="cuda"`` by default and resolves it here.
There is no automatic choice: a default-device call on a machine without
CUDA raises instead of quietly running the plain PyTorch versions on the
CPU.  ``device="cpu"`` is the one way to run the port without a card.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    this process has no usable CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            "device='cpu' to run the port's plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
