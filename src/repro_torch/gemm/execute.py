"""``execute(plan, x, w)``: run a planned GEMM.

The weight may be a ``PackedWeight`` (paid once at load: per call only
the activations are padded) or a raw tensor (``[K, N]``, or ``[N, K]``
when the plan was built with ``transposed=True``), packed inside the call
as the per-call baseline does.  A ``QuantizedPackedWeight`` runs through
the backend's dequant-fused ``run_quant``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.gemm import backends as _backends
from repro_torch.gemm.plan import GemmPlan, PACK_NONE
from repro_torch.gemm.policy import _bitexact_gate
from repro_torch.quant import ledger as _ledger
from repro_torch.quant.formats import QuantizedPackedWeight
from repro_torch.quant.kernels import quant_gate


class PlanMismatchError(ValueError):
    pass


def lead_m(x: torch.Tensor) -> int:
    """Row count of ``x[..., K]`` flattened to 2-D."""
    m = 1
    for d in x.shape[:-1]:
        m *= d
    return m


def _check(cond: bool, msg: str):
    if not cond:
        raise PlanMismatchError(msg)


def _pad_rows(x: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-x.shape[0]) % mult
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def _pad_cols(x: torch.Tensor, to: int) -> torch.Tensor:
    pad = to - x.shape[1]
    return F.pad(x, (0, pad)) if pad else x


def execute(p: GemmPlan, x: torch.Tensor, w, *, bias=None, residual=None,
            out_dtype=None) -> torch.Tensor:
    """y[..., N_out] = epilogue(x[..., K] @ w), dispatched per ``p``.

    ``bias`` [N] (one per part for a fused plan) and ``residual``
    [..., N_out] are required exactly when the plan's epilogue declares
    them; both are cast to fp32 here.  A fused plan returns the whole
    concatenated output (slice it with :func:`split_fused`) unless its
    epilogue is glu, which returns the one combined part."""
    backend = _backends.get_backend(p.backend)
    spec = p.epilogue
    _check((bias is not None) == bool(spec is not None and spec.bias),
           f"bias operand vs plan epilogue {spec} ({p.describe()})")
    _check((residual is not None) == bool(spec is not None
                                          and spec.residual),
           f"residual operand vs plan epilogue {spec} ({p.describe()})")
    lead = x.shape[:-1]
    _check(x.shape[-1] == p.k,
           f"operand K={x.shape[-1]} vs plan K={p.k} ({p.describe()})")
    x2 = x.reshape(-1, p.k)
    m = x2.shape[0]
    _check(m == p.m, f"operand M={m} vs plan M={p.m}; plans are "
                     f"shape-resolved -- re-plan for this batch")

    quant = isinstance(w, QuantizedPackedWeight)
    _check(quant == p.quantized,
           f"operand {'is' if quant else 'is not'} a quantized pack but "
           f"plan weight_format={p.weight_format!r} ({p.describe()}); "
           f"re-plan via plan_for_packed")
    if quant:
        _check(w.fmt == p.weight_format,
               f"pack format {w.fmt!r} vs plan "
               f"weight_format={p.weight_format!r}")
    if isinstance(w, packing.PackedWeight):
        _check((w.k, w.n) == (p.k, p.n),
               f"packed weight {w.shape} vs plan ({p.k},{p.n})")
        _check((w.block_n, w.block_k) == (p.block_n, p.block_k),
               f"pack blocks ({w.block_n},{w.block_k}) vs plan "
               f"({p.block_n},{p.block_k}); pack with pack_for_plan()")
        _check(w.n_splits == p.fused_n_splits,
               f"pack splits {w.n_splits} vs plan {p.fused_n_splits}")
        w_p = w.data
    else:
        _check(not p.fused_n_splits and not p.glu,
               "fused plans execute against pack_fused weights only")
        ww = w.T if p.transposed else w
        _check(tuple(ww.shape) == (p.k, p.n),
               f"weight {tuple(ww.shape)} vs plan ({p.k},{p.n})")
        if p.pack != PACK_NONE or backend.needs_blocks:
            w_p = packing.pack_percall(ww, transposed=False,
                                       block_n=p.block_n, block_k=p.block_k)
        else:
            w_p = ww

    # a ternary pack stores four K rows per codes row
    k_pad = w.k_pad if quant else w_p.shape[0]
    n_pad = w_p.shape[1]
    if k_pad != p.k:                 # weight K was pack-padded: pad x too
        x2 = _pad_cols(x2, k_pad)
    if backend.needs_blocks:
        x2 = _pad_rows(x2, p.block_m)
    x2 = x2.contiguous()

    out_cols = n_pad // 2 if p.glu else n_pad
    kw = {}
    if p.split_k > 1:
        _check(k_pad % p.split_k == 0
               and (k_pad // p.split_k) % p.block_k == 0,
               f"split_k={p.split_k} does not cut padded K={k_pad} into "
               f"whole block_k={p.block_k} slices ({p.describe()})")
        kw["split_k"] = p.split_k
    if spec is not None:
        b2 = r2 = None
        if bias is not None:
            if p.fused_n_splits:
                # per-part biases, padded into the pack's column layout
                parts = (list(bias) if isinstance(bias, (tuple, list))
                         else None)
                _check(parts is not None
                       and len(parts) == len(p.fused_n_splits),
                       f"fused plan needs one bias per part "
                       f"{p.fused_n_splits}")
                padded = []
                for b, ni in zip(parts, p.fused_n_splits):
                    b = torch.as_tensor(b, dtype=torch.float32,
                                        device=x.device).reshape(-1)
                    _check(b.shape[0] == ni,
                           f"bias width {b.shape[0]} vs part width {ni}")
                    padded.append(F.pad(b, (0, (-ni) % p.block_n)))
                b2 = torch.cat(padded)
            else:
                b2 = torch.as_tensor(bias, dtype=torch.float32,
                                     device=x.device).reshape(-1)
                _check(b2.shape[0] == p.n,
                       f"bias width {b2.shape[0]} vs plan N={p.n}")
            b2 = F.pad(b2, (0, n_pad - b2.shape[0])).contiguous()
        if residual is not None:
            r2 = residual.reshape(-1, residual.shape[-1])
            _check(tuple(r2.shape) == (m, p.n_out),
                   f"residual {tuple(r2.shape)} vs plan ({m},{p.n_out})")
            r2 = _pad_cols(r2.float(), out_cols)
            if backend.needs_blocks:
                r2 = _pad_rows(r2, p.block_m)
            r2 = r2.contiguous()
        kw.update(epilogue=spec, bias=b2, residual=r2)

    out_dtype = out_dtype or x.dtype
    if quant:
        _check(backend.run_quant is not None,
               f"backend {p.backend!r} has no dequant-fused run "
               f"(register_backend(..., run_quant=)); it cannot execute "
               f"weight_format={p.weight_format!r} plans")
        y = backend.run_quant(x2, w_p, w.scales,
                              weight_format=p.weight_format,
                              block_m=p.block_m, block_n=p.block_n,
                              block_k=p.block_k, out_dtype=out_dtype, **kw)
    else:
        y = backend.run(x2, w_p, block_m=p.block_m, block_n=p.block_n,
                        block_k=p.block_k, out_dtype=out_dtype, **kw)
    return y[:m, :p.n_out].reshape(*lead, p.n_out)


def split_fused(p: GemmPlan, y: torch.Tensor) -> tuple:
    """Slice a fused execute()'s output into its logical parts: part ``i``
    starts at the sum of the earlier parts' padded widths."""
    if not p.fused_n_splits:
        raise ValueError(f"plan carries no fused split map: "
                         f"{p.describe()}")
    if p.glu:
        raise ValueError("glu plans combine their halves in the kernel; "
                         "there is nothing to split")
    outs, off = [], 0
    for ni in p.fused_n_splits:
        outs.append(y[..., off:off + ni])
        off += -(-ni // p.block_n) * p.block_n
    return tuple(outs)


def pack_for_plan(p: GemmPlan, w: torch.Tensor, *,
                  transposed: bool | None = None,
                  dtype=None) -> packing.PackedWeight:
    """Pack ``w`` once with exactly the blocking the plan will execute."""
    return packing.pack(
        w, transposed=p.transposed if transposed is None else transposed,
        block_n=p.block_n, block_k=p.block_k, dtype=dtype)


def validate_plan(p: GemmPlan) -> bool:
    """The (memoised) bit-exactness gate on the plan's block triple,
    epilogue and split-K, run on the plain emulator: the fused path must
    be bit-identical to the unfused ``accumulator -> apply_epilogue``
    sequence.  A quantized plan is rejected when its ledger entry exceeds
    the format's tolerance, and otherwise gated by ``quant_gate`` (the
    dequant-fused plain path against the oracle over the dequantized
    panels)."""
    if p.quantized:
        ent = _ledger.lookup(p.n, p.k, p.weight_format)
        if ent is not None and not ent.within_tol:
            return False
        return quant_gate(p.block_m, p.block_n, p.block_k, p.weight_format,
                          epilogue=p.epilogue, split_k=p.split_k)
    return _bitexact_gate(p.block_m, p.block_n, p.block_k,
                          epilogue=p.epilogue, split_k=p.split_k)
