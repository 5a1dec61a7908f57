"""Quantized pre-pack formats, the dequant-fused kernels and the error
ledger (the port of ``repro.quant``, dense layouts).

    from repro_torch.core import packing
    qpw = packing.pack(w, quant="int8")       # quantize + pack at load
    p   = gemm.plan_for_packed(m, qpw)        # plan carries weight_format
    y   = gemm.execute(p, x, qpw)             # dequant-fused compute loop
"""
from repro_torch.quant import ledger
from repro_torch.quant.formats import (FORMATS, GROUP_K,
                                       SPARSE_DENSITY_THRESHOLD,
                                       QuantFormatError,
                                       QuantizedPackedWeight, dequantize,
                                       dequantize_padded, expand_scales,
                                       pack_ternary_codes, quantize,
                                       quantize_int8, quantize_pack,
                                       quantize_pack_fused, quantize_ternary,
                                       unpack_ternary_codes, weight_itemsize,
                                       zero_group_fraction)
from repro_torch.quant.kernels import (quant_gate, quant_panel_gemm,
                                       quant_panel_gemm_plain,
                                       quant_panel_gemm_splitk,
                                       quant_panel_gemm_splitk_plain)
from repro_torch.quant.ledger import (PROBE_M, TOLERANCES, LedgerEntry,
                                      QuantToleranceError)

__all__ = [
    "FORMATS", "GROUP_K", "LedgerEntry", "PROBE_M", "QuantFormatError",
    "QuantToleranceError", "QuantizedPackedWeight",
    "SPARSE_DENSITY_THRESHOLD", "TOLERANCES", "dequantize",
    "dequantize_padded", "expand_scales", "ledger", "pack_ternary_codes",
    "quant_gate", "quant_panel_gemm", "quant_panel_gemm_plain",
    "quant_panel_gemm_splitk", "quant_panel_gemm_splitk_plain", "quantize",
    "quantize_int8", "quantize_pack", "quantize_pack_fused",
    "quantize_ternary", "unpack_ternary_codes", "weight_itemsize",
    "zero_group_fraction",
]
