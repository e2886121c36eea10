"""Device selection for the port's entry points."""

from __future__ import annotations

import typing as tp

import torch

__all__ = ["resolve_device"]


def resolve_device(device: tp.Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU. When CUDA is absent and no device was given this
    raises: the port never falls back to the CPU on its own. Pass
    ``device="cpu"`` to run the plain PyTorch versions on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
