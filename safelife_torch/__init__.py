"""SafeLife on PyTorch and CUDA: the batched environment step of
``safelife_tpu`` ported to an NVIDIA Hopper card.

Tensors keep the JAX package's layouts: boards are ``(H, W, B)`` uint16
with the environment batch innermost, per-environment values are ``(B,)``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless asked otherwise.

    Raises when no CUDA device is present and the caller did not name one;
    nothing moves to the CPU behind the caller's back.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def bits16(x: torch.Tensor) -> torch.Tensor:
    """A uint16 tensor seen as int16: the same bits, no copy.  Torch's CUDA
    build indexes, selects and compares int16 tensors but not uint16 ones;
    view the result back with ``.view(torch.uint16)``."""
    return x.view(torch.int16) if x.dtype == torch.uint16 else x
