"""Weight pre-packing (paper lever 2).

A weight is packed once at model load into the layout the panel GEMM
consumes: ``[K_pad, N_pad]`` row-major, zero-padded to block multiples
(transposed first if it arrives as ``[N, K]``).  Packing is pure layout,
so an fp32 pack equals the reference's ``repro.core.packing`` pack bit
for bit.  A pack whose weight needs no padding shares the weight's
storage.  ``quant=`` quantizes at pack time instead
(``repro_torch.quant.formats``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import panel_gemm as _kernel


@dataclasses.dataclass(frozen=True)
class PackedWeight:
    """A weight packed once at load for the panel GEMM.

    data: [K_pad, N_pad] row-major, zero-padded to block multiples.
    n, k: logical (unpadded) dims.  block_n/block_k: the pack granularity.
    A fused pack (``pack_fused``) concatenates same-K weights along N, each
    part padded to a ``block_n`` multiple; ``n_splits`` holds the parts'
    logical widths and ``n`` is the padded concatenated width.
    """
    data: torch.Tensor
    n: int
    k: int
    block_n: int
    block_k: int
    n_splits: tuple = ()

    @property
    def shape(self):
        return (self.k, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device


def _pad_to(x: torch.Tensor, mults: tuple[int, int]) -> torch.Tensor:
    pk = (-x.shape[-2]) % mults[0]
    pn = (-x.shape[-1]) % mults[1]
    if pk or pn:
        x = F.pad(x, (0, pn, 0, pk))
    return x


def fit_block(dim: int, want: int, lane: int = 128) -> int:
    """Largest block <= ``want`` that divides dim rounded up to a lane
    multiple (keeps pack padding minimal on odd dims)."""
    padded = max(lane, ((dim + lane - 1) // lane) * lane)
    b = min(want, padded)
    while b > lane and padded % b:
        b //= 2
    return b if padded % b == 0 else lane


def pack(w: torch.Tensor, *, transposed: bool = False,
         block_n: int = _kernel.DEFAULT_BLOCK_N,
         block_k: int = _kernel.DEFAULT_BLOCK_K,
         dtype: torch.dtype | None = None, quant: str | None = None,
         sparse: bool | None = None) -> PackedWeight:
    """Pack a weight once at model load (``transposed``: w is [N, K]).

    ``quant`` ("int8" | "ternary") quantizes at pack time and returns a
    ``QuantizedPackedWeight``, measured and tolerance-gated by the error
    ledger; ``sparse`` is the ternary layout choice of
    ``quant.formats.quantize_pack``."""
    if quant is not None:
        from repro_torch.quant.formats import quantize_pack
        if dtype is not None:
            raise ValueError("dtype casts do not compose with quant= "
                             "(codes have a fixed storage type)")
        return quantize_pack(w, quant, transposed=transposed,
                             block_n=block_n, block_k=block_k,
                             sparse=sparse)
    if sparse:
        raise ValueError("sparse= is a ternary pack-time lever; it "
                         "requires quant='ternary'")
    if transposed:
        n, k = w.shape
        w = w.T
    else:
        k, n = w.shape
    if dtype is not None:
        w = w.to(dtype)
    block_k = fit_block(k, block_k)
    block_n = fit_block(n, block_n)
    w = _pad_to(w, (block_k, block_n)).contiguous()
    return PackedWeight(data=w, n=n, k=k, block_n=block_n, block_k=block_k)


def pack_fused(parts, *, transposed: bool = False,
               block_n: int = _kernel.DEFAULT_BLOCK_N,
               block_k: int = _kernel.DEFAULT_BLOCK_K,
               dtype: torch.dtype | None = None, quant: str | None = None,
               sparse: bool | None = None) -> PackedWeight:
    """Horizontally fuse same-input weights into ONE pack: each part padded
    to a ``block_n`` multiple, then concatenated along N, so column tiles
    never straddle parts (a static split map, and the glu halves address
    by tile offset).  ``quant`` quantizes every part at pack time
    (per-part scales), as ``pack(quant=)`` does."""
    if quant is not None:
        from repro_torch.quant.formats import quantize_pack_fused
        if dtype is not None:
            raise ValueError("dtype casts do not compose with quant=")
        return quantize_pack_fused(parts, quant, transposed=transposed,
                                   block_n=block_n, block_k=block_k,
                                   sparse=sparse)
    if sparse:
        raise ValueError("sparse= is a ternary pack-time lever; it "
                         "requires quant='ternary'")
    ws = [w.transpose(-1, -2) if transposed else w for w in parts]
    if len(ws) < 2:
        raise ValueError("pack_fused needs at least two weights; "
                         "use pack() for one")
    k = ws[0].shape[-2]
    if any(w.shape[-2] != k or w.dim() != ws[0].dim() for w in ws):
        raise ValueError(f"fused parts must share K and rank; got "
                         f"{[tuple(w.shape) for w in ws]}")
    if dtype is not None:
        ws = [w.to(dtype) for w in ws]
    block_k = fit_block(k, block_k)
    bn = min(fit_block(w.shape[-1], block_n) for w in ws)
    n_splits = tuple(int(w.shape[-1]) for w in ws)
    data = torch.cat([_pad_to(w, (block_k, bn)) for w in ws], dim=-1)
    return PackedWeight(data=data, n=int(data.shape[-1]), k=k, block_n=bn,
                        block_k=block_k, n_splits=n_splits)


def pack_percall(w: torch.Tensor, *, transposed: bool, block_n: int,
                 block_k: int, dtype: torch.dtype | None = None):
    """The stateless pack, paid inside every call (the per-call baseline:
    transpose + pad on every call)."""
    if transposed:
        w = w.T
    if dtype is not None:
        w = w.to(dtype)
    return _pad_to(w, (block_k, block_n)).contiguous()
