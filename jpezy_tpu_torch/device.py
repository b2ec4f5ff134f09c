"""Device resolution for the PyTorch port.

Every entry point takes an explicit ``device=`` (default ``"cuda"``).  A
CUDA request on a machine without a card raises: the port never picks the
CPU on its own.  The CPU is used only when a caller names it (the tests do).

The fast path's float32 DCT products must run at IEEE float32 precision.
TF32 keeps ~10 mantissa bits, which moves coefficients across integer
truncation boundaries far more often than the documented +-1 LSB envelope
allows, so a process that switched TF32 on is refused rather than silently
producing different streams.
"""
from __future__ import annotations

import torch


def check_fp32_precision() -> None:
    """Raise unless float32 matmuls run at full IEEE float32 precision."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "jpezy_tpu_torch needs torch.backends.cuda.matmul.allow_tf32 = "
            "False (TF32 breaks the fast-mode DCT envelope)")
    prec = torch.get_float32_matmul_precision()
    if prec != "highest":
        raise RuntimeError(
            "jpezy_tpu_torch needs torch.get_float32_matmul_precision() == "
            f"'highest', got {prec!r}")


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """Validate a caller's device choice; no silent CPU fallback."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "available (pass device='cpu' explicitly for the CPU path)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    check_fp32_precision()
    return dev
