"""Quantized pre-pack formats: paper lever 2 below fp32.

The port of ``repro.quant.formats`` for the dense layouts:

  * ``int8``    -- group-wise symmetric codes in [-127, 127], one fp32
                   scale per (output column, ``GROUP_K``-row K group).
  * ``ternary`` -- TWN-style codes in {-1, 0, +1} with the same scale
                   grouping, four 2-bit codes packed per byte along K.

``core.packing.pack(quant=...)`` / ``pack_fused(quant=...)`` produce a
:class:`QuantizedPackedWeight` once at model load; the dequant-fused
kernels (``quant/kernels.py``) dequantize each weight element on its way
to the fp32 accumulator.  Every pack is measured against its fp32 weight
by the error ledger (``quant/ledger.py``), which enforces the format's
tolerance at pack time.

Numerics against the reference.  The int8 quantizer uses only
order-free reductions (a max) and elementwise ops, so its codes and
scales equal the reference's bit for bit.  The ternary quantizer's
threshold and scale are fp32 sums over the 128 rows of a group; here
each is a fixed-order pairwise tree (add halves until one row is left),
so a pack is the same on the CPU and on the card, and stacked ``[L, K,
N]`` and per-layer packs are bit-identical.  XLA sums in another order,
so ternary scales may differ from the reference's by a few fp32 ulps, and
a code by one step where ``|w|`` lies within those ulps of its group's
threshold.

Not ported yet: the compressed sparse-ternary layout (the reference's
``SparseTernaryPackedWeight`` and its group-walk kernel).  Asking for it
(``sparse=True``), or a ternary pack whose zero-group fraction reaches
``SPARSE_DENSITY_THRESHOLD`` under ``sparse=None`` (where the reference
would compress), raises ``NotImplementedError``; a pack is never quietly
kept dense where the reference would compress it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.packing import PackedWeight, fit_block
from repro_torch.kernels import panel_gemm as _kernel

FORMATS = ("int8", "ternary")

# TWN threshold factor: codes are 0 where |w| <= TERNARY_DELTA * mean|w|
# over the group; the group's scale is the mean magnitude of the survivors.
TERNARY_DELTA = 0.7

# K rows per scale group (per output column).  It divides every quantized
# block_k, so a kernel K tile never straddles a scale group.
GROUP_K = 128

# Zero-group fraction at which the reference compresses a ternary pack by
# default (the sparse layout, not ported yet: see the module docstring).
SPARSE_DENSITY_THRESHOLD = 0.3

# Four packed zero codes (code 0 stores as 0b01): what an all-zero K run,
# and pack padding, pack to.
_TERNARY_ZERO_BYTE = 0x55


@dataclasses.dataclass(frozen=True)
class QuantizedPackedWeight(PackedWeight):
    """A weight quantized and packed once at load.

    data:   codes -- int8 ``[..., K_pad, N_pad]`` for ``int8``; uint8
            ``[..., K_pad // 4, N_pad]`` for ``ternary`` (four 2-bit codes
            per byte along K, stored as code + 1).
    scales: fp32 ``[..., K_pad // GROUP_K, N_pad]`` (all-padding groups
            carry scale 0 and code 0, so padded tiles dequantize to 0).
    fmt:    ``"int8"`` | ``"ternary"`` (rides onto the plan as
            ``weight_format``).
    sparsity: fraction of zero codes among the logical ones (ternary;
            -1.0 for int8).
    """
    scales: torch.Tensor | None = None
    fmt: str = "int8"
    sparsity: float = -1.0

    @property
    def k_pad(self) -> int:
        """Padded contraction depth (the codes' K rows, unpacked)."""
        rows = self.data.shape[-2]
        return rows * 4 if self.fmt == "ternary" else rows

    @property
    def n_pad(self) -> int:
        return self.data.shape[-1]


class QuantFormatError(ValueError):
    pass


def _check_fmt(fmt: str):
    if fmt not in FORMATS:
        raise QuantFormatError(
            f"unknown quant format {fmt!r}; choose from {FORMATS}")


def weight_itemsize(fmt: str | None) -> float:
    """Bytes per weight element the kernel streams: fp32 4.0, int8 1.0,
    ternary 0.25."""
    if fmt in (None, "fp32"):
        return 4.0
    _check_fmt(fmt)
    return 1.0 if fmt == "int8" else 0.25


# ------------------------------------------------------------ quantizers
def _pad_tail(x: torch.Tensor, pk: int, pn: int) -> torch.Tensor:
    return F.pad(x, (0, pn, 0, pk)) if (pk or pn) else x


def _grouped(w: torch.Tensor):
    """``[..., K, N]`` -> (``[..., Kg, GROUP_K, N]`` zero-padded view, pad
    rows added).  Group statistics run over axis -2 of the view."""
    k = w.shape[-2]
    pk = (-k) % GROUP_K
    w = _pad_tail(w, pk, 0)
    kg = w.shape[-2] // GROUP_K
    return w.reshape(*w.shape[:-2], kg, GROUP_K, w.shape[-1]), pk


def _ungroup(codes_g: torch.Tensor, k: int) -> torch.Tensor:
    out = codes_g.reshape(*codes_g.shape[:-3],
                          codes_g.shape[-3] * GROUP_K, codes_g.shape[-1])
    return out[..., :k, :]


def _group_sum(g: torch.Tensor) -> torch.Tensor:
    """Sum over the GROUP_K rows (axis -2) in a fixed pairwise order:
    halves are added until one row is left.  The order is the same for
    every group, layer, shape and device; keeps the axis (size 1)."""
    while g.shape[-2] > 1:
        h = g.shape[-2] // 2
        g = g[..., :h, :] + g[..., h:, :]
    return g


def expand_scales(scales: torch.Tensor, k: int) -> torch.Tensor:
    """Broadcast group scales ``[..., Kg, N]`` to per-row ``[..., k, N]``."""
    return torch.repeat_interleave(scales, GROUP_K, dim=-2)[..., :k, :]


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int8 for ``w[..., K, N]``: ``scale = max_group
    |w| / 127`` per (column, K group), codes ``round(w / scale)`` (half to
    even) clipped to [-127, 127]; all-zero groups get scale 0 and codes 0.
    Returns (codes int8 ``[..., K, N]``, scales fp32 ``[..., ceil(K /
    GROUP_K), N]``)."""
    w = w.float()
    k = w.shape[-2]
    g, _ = _grouped(w)
    amax = g.abs().amax(dim=-2, keepdim=True)
    # a true division by a tensor: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which can differ in the last bit
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(g / safe), -127, 127).to(torch.int8)
    return _ungroup(q, k), scale[..., 0, :]


def quantize_ternary(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """TWN-style ternary for ``w[..., K, N]``: codes in {-1, 0, +1} (int8,
    not yet 2-bit packed) and a per-(column, K group) fp32 scale.  The
    threshold ``delta = TERNARY_DELTA * mean_group |w|`` (over the group's
    logical rows) zeroes the small weights; the scale is the mean
    magnitude of the survivors.  Every group sum is :func:`_group_sum`'s
    fixed tree."""
    w = w.float()
    k = w.shape[-2]
    g, _ = _grouped(w)
    mag = g.abs()
    kg = g.shape[-3]
    counts = torch.full((kg, 1, 1), float(GROUP_K), device=w.device)
    counts[-1] = float(k - (kg - 1) * GROUP_K)   # the tail group's rows
    factor = torch.tensor(TERNARY_DELTA, dtype=torch.float32,
                          device=w.device)
    delta = factor * _group_sum(mag) / counts
    mask = mag > delta
    t = torch.where(mask, torch.sign(g), torch.zeros_like(g)).to(torch.int8)
    cnt = mask.sum(dim=-2, keepdim=True).float()
    survivors = _group_sum(torch.where(mask, mag, torch.zeros_like(mag)))
    s = torch.where(cnt > 0, survivors / torch.clamp(cnt, min=1.0),
                    torch.zeros_like(survivors))
    return _ungroup(t, k), s[..., 0, :]


def quantize(w: torch.Tensor, fmt: str) -> tuple[torch.Tensor, torch.Tensor]:
    _check_fmt(fmt)
    return quantize_int8(w) if fmt == "int8" else quantize_ternary(w)


# ------------------------------------------------- ternary 2-bit packing
def pack_ternary_codes(t: torch.Tensor) -> torch.Tensor:
    """Pack ternary codes ``[..., K, N]`` (K % 4 == 0) into uint8 ``[...,
    K // 4, N]``: four consecutive K rows per byte, row ``4r+i`` in bits
    ``[2i, 2i+2)``, stored as ``code + 1`` in {0, 1, 2}."""
    k = t.shape[-2]
    if k % 4:
        raise QuantFormatError(f"ternary packing needs K % 4 == 0; got "
                               f"K={k} (pad to the block first)")
    c = (t.to(torch.int32) + 1).to(torch.uint8)
    c4 = c.reshape(*t.shape[:-2], k // 4, 4, t.shape[-1])
    out = c4[..., 0, :]
    for i in range(1, 4):
        out = out | (c4[..., i, :] << (2 * i))
    return out


def unpack_ternary_codes(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_ternary_codes`: fp32 codes in {-1, 0, +1},
    ``[..., K, N]`` (the unpack every consumer shares)."""
    parts = [((packed >> (2 * i)) & 3).float() - 1.0 for i in range(4)]
    stacked = torch.stack(parts, dim=-2)            # [..., K//4, 4, N]
    return stacked.reshape(*packed.shape[:-2], packed.shape[-2] * 4,
                           packed.shape[-1])


# ------------------------------------------------------------ dequantize
def dequantize_padded(data: torch.Tensor, scales: torch.Tensor,
                      fmt: str) -> torch.Tensor:
    """Packed codes back to the padded fp32 panels ``[..., K_pad, N_pad]``:
    codes -> fp32, times the group-expanded scales, one rounding per
    element.  The CUDA kernels dequantize each element to this value."""
    _check_fmt(fmt)
    if fmt == "ternary":
        codes = unpack_ternary_codes(data)
    else:
        codes = data.float()
    return codes * expand_scales(scales.float(), codes.shape[-2])


def dequantize(qpw: QuantizedPackedWeight) -> torch.Tensor:
    """Padded fp32 panels for a quantized pack (the ledger's oracle weight
    and the dequantize-then-matmul baseline's operand)."""
    return dequantize_padded(qpw.data, qpw.scales, qpw.fmt)


# ------------------------------------------------------------- packing
def zero_group_fraction(qpw: QuantizedPackedWeight) -> float:
    """Fraction of the pack's ``GROUP_K`` K groups whose codes are zero in
    every column (and every stacked layer): the groups the reference's
    compressed layout would drop."""
    data = qpw.data
    rpg = GROUP_K // 4
    kg = data.shape[-2] // rpg
    g = data.reshape(-1, kg, rpg, data.shape[-1])
    occupied = (g != _TERNARY_ZERO_BYTE).any(dim=3).any(dim=2).any(dim=0)
    return 1.0 - float(occupied.float().mean())


def _refuse_sparse(qpw: QuantizedPackedWeight, sparse: bool | None):
    """The reference's pack-time sparse arm, which this package does not
    have yet: refuse wherever the reference would compress."""
    if sparse is False:
        return
    if qpw.fmt != "ternary":
        if sparse:
            raise QuantFormatError(
                f"sparse layout is ternary-only; got {qpw.fmt!r}")
        return
    if sparse:
        raise NotImplementedError(
            "the compressed sparse-ternary layout is not ported yet "
            "(pack with sparse=False for the dense layout)")
    gs = zero_group_fraction(qpw)
    if gs >= SPARSE_DENSITY_THRESHOLD:
        raise NotImplementedError(
            f"this ternary pack has zero-group fraction {gs:.3f} >= "
            f"{SPARSE_DENSITY_THRESHOLD}, where the reference compresses "
            f"it; the compressed layout is not ported yet (pass "
            f"sparse=False to keep the dense layout)")


def _sparsity(t: torch.Tensor) -> float:
    """Zero fraction of the logical codes."""
    return float((t == 0).sum()) / max(1, t.numel())


def _fit_group_block_k(k: int, block_k: int | None) -> int:
    """A pack's block_k that divides the padded K (``fit_block``) and spans
    whole GROUP_K scale groups (rounded down to a GROUP_K multiple)."""
    bk = fit_block(k, block_k or _kernel.DEFAULT_BLOCK_K)
    if bk % GROUP_K:
        bk = max(GROUP_K, (bk // GROUP_K) * GROUP_K)
    return bk


def _finish_pack(q, s, *, n, k, block_n, block_k, n_splits, fmt, sparsity,
                 sparse):
    data = pack_ternary_codes(q) if fmt == "ternary" else q
    qpw = QuantizedPackedWeight(
        data=data.contiguous(), n=n, k=k, block_n=block_n, block_k=block_k,
        n_splits=n_splits, scales=s.contiguous(), fmt=fmt,
        sparsity=sparsity)
    _refuse_sparse(qpw, sparse)
    return qpw


def quantize_pack(w: torch.Tensor, fmt: str, *, transposed: bool = False,
                  block_n: int | None = None, block_k: int | None = None,
                  measure: bool = True,
                  sparse: bool | None = None) -> QuantizedPackedWeight:
    """Quantize and pack ``w[..., K, N]`` (``[..., N, K]`` with
    ``transposed``) once at model load; leading dims ride through.

    Quantization runs on the logical weight (padding never enters a
    group's statistics), then codes and scales pad with 0.
    ``measure=True`` records the pack's error against ``w`` in the error
    ledger and enforces the format's tolerance.  ``sparse``: see the
    module docstring."""
    _check_fmt(fmt)
    if transposed:
        w = w.transpose(-1, -2)
    k, n = int(w.shape[-2]), int(w.shape[-1])
    block_k = _fit_group_block_k(k, block_k)
    block_n = fit_block(n, block_n or _kernel.DEFAULT_BLOCK_N)
    q, s = quantize(w, fmt)
    sparsity = _sparsity(q) if fmt == "ternary" else -1.0
    pk, pn = (-k) % block_k, (-n) % block_n
    q = _pad_tail(q, pk, pn)
    s = _pad_tail(s, q.shape[-2] // GROUP_K - s.shape[-2], pn)
    qpw = _finish_pack(q, s, n=n, k=k, block_n=block_n, block_k=block_k,
                       n_splits=(), fmt=fmt, sparsity=sparsity,
                       sparse=sparse)
    if measure:
        from repro_torch.quant import ledger
        ledger.measure(w, qpw, enforce=True)
    return qpw


def quantize_pack_fused(parts, fmt: str, *, transposed: bool = False,
                        block_n: int | None = None,
                        block_k: int | None = None, measure: bool = True,
                        sparse: bool | None = None) -> QuantizedPackedWeight:
    """Horizontal fusion in a quantized format: each same-K part quantized
    per its own columns, padded to a ``block_n`` multiple, concatenated
    along N (the static split map of ``core.packing.pack_fused``)."""
    _check_fmt(fmt)
    ws = [w.transpose(-1, -2) if transposed else w for w in parts]
    if len(ws) < 2:
        raise ValueError("quantize_pack_fused needs at least two weights; "
                         "use quantize_pack for one")
    k = int(ws[0].shape[-2])
    if any(w.shape[-2] != k or w.dim() != ws[0].dim() for w in ws):
        raise ValueError(f"fused parts must share K and rank; got "
                         f"{[tuple(w.shape) for w in ws]}")
    block_k = _fit_group_block_k(k, block_k)
    bn = min(fit_block(int(w.shape[-1]), block_n or _kernel.DEFAULT_BLOCK_N)
             for w in ws)
    n_splits = tuple(int(w.shape[-1]) for w in ws)
    pk = (-k) % block_k
    qs, ss, zeros, elems = [], [], 0, 0
    for w in ws:
        q, s = quantize(w, fmt)
        if fmt == "ternary":
            zeros += int((q == 0).sum())
            elems += q.numel()
        pn = (-int(w.shape[-1])) % bn
        q = _pad_tail(q, pk, pn)
        qs.append(q)
        ss.append(_pad_tail(s, q.shape[-2] // GROUP_K - s.shape[-2], pn))
    codes = torch.cat(qs, dim=-1)
    scales = torch.cat(ss, dim=-1)
    del qs, ss
    qpw = _finish_pack(codes, scales, n=int(codes.shape[-1]), k=k,
                       block_n=bn, block_k=block_k, n_splits=n_splits,
                       fmt=fmt, sparsity=(zeros / elems) if elems else -1.0,
                       sparse=sparse)
    if measure:
        from repro_torch.quant import ledger
        ledger.measure(torch.cat(
            [_pad_tail(w, 0, (-int(w.shape[-1])) % bn) for w in ws],
            dim=-1), qpw, enforce=True)
    return qpw
