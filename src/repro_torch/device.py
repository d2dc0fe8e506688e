"""Device resolution shared by every entry point of the port.

Entry points run on the CUDA card unless the caller asks for the CPU
explicitly.  Without a card they raise: nothing in the port falls back to
the CPU on its own.  A model built on ``device="meta"`` has every
parameter's shape and dtype and no storage: it counts a full-width
model's parameters without allocating it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card.  A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def seeded_generator(dev: torch.device, seed: int) -> torch.Generator:
    """The generator that draws a model's initial weights on ``dev`` (a CPU
    generator for ``meta``, where nothing is drawn)."""
    return torch.Generator(
        device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
