"""Plain PyTorch oracles for the kernels.

* ``gemm_matmul``  -- one ``torch.matmul`` with fp32 accumulation: the
                      vendor-library analogue, used for allclose checks.
* ``gemm_blocked`` -- sums K in ``block_k`` blocks, in block order, as the
                      reference's blocked oracle does.  Each row is its own
                      fixed-shape product ``[1, block_k] @ [block_k, N]``
                      per block, so a row's result depends on that row and
                      the weight only: not on M, not on the other rows.  A
                      single ``torch.matmul`` over all rows does not have
                      that property on the CPU (its result for row 0 changes
                      between M = 128 and M <= 16), and batch invariance is
                      what the serve == generate gate rests on.
* ``gemm_splitk``  -- per-slice ``gemm_blocked`` partials combined by the
                      fixed pairwise tree (``panel_gemm.splitk_combine``).
"""
from __future__ import annotations

import torch


def gemm_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reference GEMM: one fp32 matmul, cast back to x's dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def gemm_blocked(x: torch.Tensor, w: torch.Tensor, block_k: int,
                 out_dtype=None) -> torch.Tensor:
    """K-blocked GEMM: fixed-shape row products summed in block order."""
    m, k = x.shape
    if k % block_k:
        raise ValueError(f"K={k} is not a multiple of block_k={block_k}")
    out_dtype = out_dtype or x.dtype
    xf, wf = x.float(), w.float()
    rows = []
    for i in range(m):
        acc = torch.zeros((1, wf.shape[1]), dtype=torch.float32,
                          device=x.device)
        for kk in range(0, k, block_k):
            acc = acc + torch.matmul(xf[i:i + 1, kk:kk + block_k],
                                     wf[kk:kk + block_k])
        rows.append(acc)
    if not rows:
        return torch.zeros((0, wf.shape[1]), dtype=out_dtype,
                           device=x.device)
    return torch.cat(rows).to(out_dtype)


def gemm_splitk(x: torch.Tensor, w: torch.Tensor, block_k: int,
                split_k: int, out_dtype=None) -> torch.Tensor:
    """Split-K oracle: K cut into ``split_k`` contiguous slices, each
    accumulated in ``gemm_blocked`` order, combined by the fixed pairwise
    tree.  ``split_k == 1`` is ``gemm_blocked`` exactly."""
    from repro_torch.kernels.panel_gemm import splitk_combine
    m, k = x.shape
    if k % split_k or (k // split_k) % block_k:
        raise ValueError(f"K={k} does not cut into {split_k} slices of "
                         f"whole block_k={block_k} blocks")
    ks = k // split_k
    out_dtype = out_dtype or x.dtype
    parts = [gemm_blocked(x[:, s * ks:(s + 1) * ks],
                          w[s * ks:(s + 1) * ks], block_k,
                          out_dtype=torch.float32)
             for s in range(split_k)]
    return splitk_combine(parts).to(out_dtype)
