"""Dequant-fused panel GEMM: the quantized formats' two CUDA kernels, their
plain versions, and the structural gate.

``quant_panel_gemm`` (prefill, and decode at ``split_k = 1``; a glu
variant over the two halves of a fused gate+up pack) and
``quant_panel_gemm_splitk`` (the decode lane) are the wrappers of the
hand-written kernels in ``csrc/quant_gemm.cu``; they replace the Pallas
kernels of ``repro.quant.kernels`` of the same names.  The weight arrives
as int8 codes or 2-bit ternary bytes plus per-(column, 128-row group)
scales; each element is dequantized as ``float(code) * scale``, rounded
once, on its way to the fp32 accumulator, and the K order is the fp32
kernel's.  So a launch equals, bit for bit, ``panel_gemm`` on
``formats.dequantize_padded(codes, scales)`` at the same blocks, and the
plain versions obey the same law against ``panel_gemm_plain``.

Each wrapper checks its operands, allocates its outputs, launches on the
current stream, raises if the launch failed, and counts its launches in
``<wrapper>.launches``.  Given CPU tensors it runs its plain version;
given CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitexact
from repro_torch.kernels import cuda_lib, ref
from repro_torch.kernels import panel_gemm as _kernel
from repro_torch.kernels.panel_gemm import (DECODE_BLOCK_M, DEFAULT_BLOCK_K,
                                            DEFAULT_BLOCK_M, DEFAULT_BLOCK_N,
                                            EpilogueSpec, apply_epilogue,
                                            splitk_combine)
from repro_torch.quant import formats as F

_CODE_DTYPE = {"int8": torch.int8, "ternary": torch.uint8}


def _quant_geometry(x, codes, scales, bias, residual, spec, *, fmt,
                    block_m, block_n, block_k, split_k=1):
    """The reference's asserts for a quantized call, raised as
    ValueError; returns (m, k, n, n_out)."""
    F._check_fmt(fmt)
    kdiv = 4 if fmt == "ternary" else 1
    if codes.dim() != 2:
        raise ValueError(f"codes must be 2-D; got {tuple(codes.shape)}")
    k, n = codes.shape[0] * kdiv, codes.shape[1]
    if block_k % F.GROUP_K:
        raise ValueError(f"block_k={block_k} must span whole "
                         f"GROUP_K={F.GROUP_K} scale groups")
    geo = _kernel._geometry(x, (k, n), bias, residual, spec,
                            block_m=block_m, block_n=block_n,
                            block_k=block_k, split_k=split_k)
    if tuple(scales.shape) != (k // F.GROUP_K, n):
        raise ValueError(f"scales {tuple(scales.shape)} vs expected "
                         f"({k // F.GROUP_K},{n})")
    return geo


def _check_codes(x, codes, fmt):
    if codes.device != x.device:
        raise ValueError(f"codes are on {codes.device}, x on {x.device}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    if codes.dtype != _CODE_DTYPE[fmt]:
        raise TypeError(f"{fmt} codes must be {_CODE_DTYPE[fmt]}; got "
                        f"{codes.dtype}")


# ---------------------------------------------------------- quant_panel_gemm
def quant_panel_gemm_plain(x, codes, scales, bias=None, residual=None, *,
                           weight_format: str,
                           block_k: int = DEFAULT_BLOCK_K, out_dtype=None,
                           epilogue: EpilogueSpec | None = None):
    """The plain version of ``quant_panel_gemm``: dequantize, then
    ``panel_gemm_plain`` (the blocked emulator, the epilogue, one cast)."""
    w = F.dequantize_padded(codes, scales, weight_format)
    return _kernel.panel_gemm_plain(x, w, bias, residual, block_k=block_k,
                                    out_dtype=out_dtype, epilogue=epilogue)


def quant_panel_gemm(x, codes, scales, bias=None, residual=None, *,
                     weight_format: str, block_m: int = DEFAULT_BLOCK_M,
                     block_n: int = DEFAULT_BLOCK_N,
                     block_k: int = DEFAULT_BLOCK_K, out_dtype=None,
                     epilogue: EpilogueSpec | None = None):
    """C[M, N_out] = epilogue(x @ dequant(codes, scales)) on pre-padded
    operands: x ``[M_pad, K_pad]``, codes int8 ``[K_pad, N_pad]`` or
    ternary uint8 ``[K_pad / 4, N_pad]``, scales fp32 ``[K_pad / 128,
    N_pad]``; with a glu epilogue the pack holds [gate | up] halves and
    N_out = N_pad / 2.  CUDA operands launch ``repro_quant_panel_gemm``;
    CPU operands run :func:`quant_panel_gemm_plain`."""
    spec = _kernel._spec(epilogue)
    m, k, n, n_out = _quant_geometry(
        x, codes, scales, bias, residual, spec, fmt=weight_format,
        block_m=block_m, block_n=block_n, block_k=block_k)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quant_panel_gemm_plain(x, codes, scales, bias, residual,
                                      weight_format=weight_format,
                                      block_k=block_k, out_dtype=out_dtype,
                                      epilogue=spec)
    _kernel._check_cuda(x, scales, bias, residual, out_dtype)
    _check_codes(x, codes, weight_format)
    s = spec or EpilogueSpec()
    cap = s.softcap if s.softcap is not None else 0.0
    rcp = 1.0 / s.softcap if s.softcap is not None else 0.0
    lib = cuda_lib.load("quant_gemm")
    with torch.cuda.device(x.device):
        out = torch.empty((m, n_out), dtype=out_dtype, device=x.device)
        err = lib.repro_quant_panel_gemm(
            x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
            scales.data_ptr(), int(weight_format == "ternary"),
            _kernel._ptr(bias), _kernel._ptr(residual), out.data_ptr(),
            int(out_dtype == torch.bfloat16), m, k, n, n_out,
            _kernel._ACT_CODE[s.act], _kernel._ACT_CODE[s.glu],
            int(s.softcap is not None), cap, rcp,
            torch.cuda.current_stream(x.device).cuda_stream)
    _kernel._launched("quant_panel_gemm", err)
    quant_panel_gemm.launches += 1
    return out


quant_panel_gemm.launches = 0


# ------------------------------------------------------------ split-K lane
def quant_panel_gemm_splitk_plain(x, codes, scales, bias=None, residual=None,
                                  *, weight_format: str, split_k: int,
                                  block_k: int = DEFAULT_BLOCK_K,
                                  out_dtype=None,
                                  epilogue: EpilogueSpec | None = None):
    """The plain version of ``quant_panel_gemm_splitk``: dequantize, then
    ``panel_gemm_splitk_plain`` (per-slice blocked partials, the fixed
    combine tree, the epilogue, one cast)."""
    w = F.dequantize_padded(codes, scales, weight_format)
    return _kernel.panel_gemm_splitk_plain(
        x, w, bias, residual, split_k=split_k, block_k=block_k,
        out_dtype=out_dtype, epilogue=epilogue)


def quant_panel_gemm_splitk(x, codes, scales, bias=None, residual=None, *,
                            weight_format: str, split_k: int,
                            block_m: int = DECODE_BLOCK_M,
                            block_n: int = DEFAULT_BLOCK_N,
                            block_k: int = DEFAULT_BLOCK_K, out_dtype=None,
                            epilogue: EpilogueSpec | None = None):
    """C = epilogue(splitk_combine(per-slice x @ dequant(codes, scales))),
    the quantized decode lane.  CUDA operands launch
    ``repro_quant_panel_gemm_splitk`` for the fp32 partials ``[split_k, M,
    N]``; the combine tree and the epilogue then run as plain torch ops,
    as in the reference.  CPU operands run
    :func:`quant_panel_gemm_splitk_plain`."""
    spec = _kernel._spec(epilogue)
    m, k, n, _ = _quant_geometry(
        x, codes, scales, bias, residual, spec, fmt=weight_format,
        block_m=block_m, block_n=block_n, block_k=block_k, split_k=split_k)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quant_panel_gemm_splitk_plain(
            x, codes, scales, bias, residual, weight_format=weight_format,
            split_k=split_k, block_k=block_k, out_dtype=out_dtype,
            epilogue=spec)
    _kernel._check_cuda(x, scales, bias, residual, out_dtype)
    _check_codes(x, codes, weight_format)
    lib = cuda_lib.load("quant_gemm")
    with torch.cuda.device(x.device):
        partials = torch.empty((split_k, m, n), dtype=torch.float32,
                               device=x.device)
        err = lib.repro_quant_panel_gemm_splitk(
            x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
            scales.data_ptr(), int(weight_format == "ternary"),
            partials.data_ptr(), m, k, n, split_k,
            torch.cuda.current_stream(x.device).cuda_stream)
    _kernel._launched("quant_panel_gemm_splitk", err)
    quant_panel_gemm_splitk.launches += 1
    acc = splitk_combine(partials)
    if spec is not None:
        acc = apply_epilogue(acc, spec, bias=bias, residual=residual)
    return acc.to(out_dtype)


quant_panel_gemm_splitk.launches = 0


# ------------------------------------------------------- structural gate
_gate_memo: dict[tuple, bool] = {}


def quant_gate(bm: int, bn: int, bk: int, fmt: str, *,
               epilogue: EpilogueSpec | None = None,
               reduced_k_blocks: int = 2, seed: int = 0,
               split_k: int = 1) -> bool:
    """The reject protocol for a quantized block triple, re-based on the
    plain versions: on a reduced shape with a real K carry, the
    dequant-fused plain path (split-K for ``split_k > 1``) must be
    bit-identical to the blocked (or split-K) oracle over the dequantized
    panels, then ``apply_epilogue``, then the cast.  It attests the
    tiling, the dequant placement and the accumulation order; the
    format's error against fp32 is the ledger's concern.  Memoised."""
    key = (bm, bn, bk, fmt, epilogue, split_k)
    if key in _gate_memo:
        return _gate_memo[key]
    rng = np.random.default_rng(seed)
    glu = epilogue is not None and epilogue.glu is not None
    m_r, k_r = bm, reduced_k_blocks * bk * split_k
    n_r = 2 * bn if glu else bn
    x = torch.from_numpy(rng.standard_normal((m_r, k_r)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k_r, n_r)).astype(np.float32))
    q, s = F.quantize(w, fmt)
    data = F.pack_ternary_codes(q) if fmt == "ternary" else q
    deq = F.dequantize_padded(data, s, fmt)
    bias = res = None
    if epilogue is not None and epilogue.bias:
        bias = torch.from_numpy(rng.standard_normal((n_r,)).astype(
            np.float32))
    if epilogue is not None and epilogue.residual:
        res = torch.from_numpy(rng.standard_normal(
            (m_r, bn if glu else n_r)).astype(np.float32))
    if split_k > 1:
        y = quant_panel_gemm_splitk_plain(
            x, data, s, bias, res, weight_format=fmt, split_k=split_k,
            block_k=bk, epilogue=epilogue)
        acc = ref.gemm_splitk(x, deq, bk, split_k, out_dtype=torch.float32)
    else:
        y = quant_panel_gemm_plain(x, data, s, bias, res, weight_format=fmt,
                                   block_k=bk, epilogue=epilogue)
        acc = ref.gemm_blocked(x, deq, bk, out_dtype=torch.float32)
    if epilogue is not None and not epilogue.is_noop:
        acc = apply_epilogue(acc, epilogue, bias=bias, residual=res)
    ok = bitexact.bit_identical(y, acc.to(x.dtype))
    _gate_memo[key] = ok
    return ok
