"""The one place where the port picks its device."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda:0`` (or the CUDA device asked for) when a card is
    present; the CPU only when the caller asks for ``"cpu"``.

    There is no silent fallback: ``None`` or a CUDA device without a
    card raises, so a run that was meant for the GPU never ends up on
    the host unnoticed.
    """
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cpu":
            return dev
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {device!r}")
    else:
        dev = torch.device("cuda")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    return torch.device("cuda", dev.index if dev.index is not None else 0)


def use_full_float32() -> None:
    """Turn TF32 off for matrix products and cuDNN convolutions.

    The JAX package computes the main path and the distance products of
    cluster and classify in float32; on a card PyTorch would otherwise
    round their inputs to TF32.  Each stage entry point calls this."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
