"""Bit-exactness harness (the paper's §4.1 verification discipline).

The full output is compared bit for bit where the port claims identity
(determinism, batch invariance, fused == unfused), and the max |diff| is
sampled at the paper's coprime strides (every 997th / 1,023rd element)
where it reports a difference instead.  Accepts torch tensors or arrays.
"""
from __future__ import annotations

import numpy as np
import torch

COPRIME_STRIDES = (997, 1023)


def _np(x, *, bits: bool = False) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:   # numpy has no bf16
            return (x.view(torch.int16) if bits else x.float()).numpy()
        return x.numpy()
    return np.asarray(x)


def sampled(x, stride: int = 997) -> np.ndarray:
    flat = _np(x).reshape(-1)
    if flat.size <= stride:
        return flat
    return flat[::stride]


def _values(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


def max_abs_diff_sampled(a, b, stride: int = 997) -> float:
    va = _values(a).reshape(-1)
    vb = _values(b).reshape(-1)
    if va.size > stride:
        va, vb = va[::stride], vb[::stride]
    return float(np.max(np.abs(va - vb))) if va.size else 0.0


def bit_identical(a, b) -> bool:
    """Bitwise equality over the FULL output (shape and dtype included)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
    an, bn = _np(a, bits=True), _np(b, bits=True)
    if an.shape != bn.shape or an.dtype != bn.dtype:
        return False
    return bool(np.array_equal(an.view(np.uint8), bn.view(np.uint8)))


def report(a, ref) -> dict:
    """Paper-style row: bit-exact? + coprime-stride max-abs-diff."""
    return {
        "bit_exact": bit_identical(a, ref),
        "max_abs_diff_997": max_abs_diff_sampled(a, ref, 997),
        "max_abs_diff_1023": max_abs_diff_sampled(a, ref, 1023),
    }
