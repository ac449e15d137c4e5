"""Device choice shared by every entry point of the port."""

import torch


def resolve_device(device=None):
    """``None`` means the card (``"cuda"``). A CUDA device on a machine
    without CUDA raises: the port never runs on the CPU unless the caller
    asks for it with ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device} (cuda or cpu)")
    return device
