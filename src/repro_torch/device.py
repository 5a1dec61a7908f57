"""Where the port's entry points run.

Every entry point (``Engine``, ``model_zoo.build``, the kernel wrappers
through their operands) runs on CUDA unless the caller asks for the CPU.
With no CUDA device present, asking for CUDA (or asking for nothing)
raises: the port never falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Initialising a CUDA device also pins fp32
    matrix products and convolutions to IEEE fp32 (TF32 off): fp32 in
    this package means IEEE fp32."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
