"""The port's dequant-fused CUDA kernels on the card.

Every case carries the ``gpu`` marker and skips where there is no card
(the kernels have no CPU mode).  The file imports only torch and the port,
so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_quant_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitexact
from repro_torch.kernels import panel_gemm as K
from repro_torch.models import model_zoo
from repro_torch.quant import formats as F
from repro_torch.quant import kernels as QK
from repro_torch.runtime.serve_loop import Engine

pytestmark = pytest.mark.gpu

FORMATS = ("int8", "ternary")
EPILOGUES = [
    None,
    dict(bias=True, act="gelu"),
    dict(softcap=20.0, residual=True),
    dict(bias=True, act="silu", softcap=8.0, residual=True),
    dict(glu="silu"),
    dict(glu="gelu", bias=True, residual=True),
]


def _id(spec):
    return "none" if spec is None else "-".join(
        f"{k}={v}" for k, v in spec.items())


@pytest.fixture
def cuda():
    """The card; decided here, not at import, so every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _operands(dev, fmt, spec, m, k, n, x_dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    glu = spec is not None and "glu" in spec
    x = torch.randn((m, k), generator=gen, device=dev).to(x_dtype)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    q, s = F.quantize(w, fmt)
    codes = F.pack_ternary_codes(q) if fmt == "ternary" else q
    bias = (torch.randn((n,), generator=gen, device=dev)
            if spec and spec.get("bias") else None)
    res = (torch.randn((m, n // 2 if glu else n), generator=gen, device=dev)
           if spec and spec.get("residual") else None)
    return (x, codes.contiguous(), s.contiguous(), bias, res,
            K.EpilogueSpec(**spec) if spec else None)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", EPILOGUES, ids=_id)
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_kernel_matches_plain_and_the_fp32_kernel(cuda, fmt, spec,
                                                         x_dtype):
    """Within ``gemm_error_bound`` of the plain version; bit for bit the
    fp32 kernel on the dequantized weight; bitwise from launch to
    launch."""
    glu = spec is not None and "glu" in spec
    x, codes, s, bias, res, es = _operands(cuda, fmt, spec, 64, 512,
                                           512 if glu else 256, x_dtype)
    kw = dict(block_m=64, block_n=128, block_k=128, epilogue=es)
    n0 = QK.quant_panel_gemm.launches
    y = QK.quant_panel_gemm(x, codes, s, bias, res, weight_format=fmt, **kw)
    torch.cuda.synchronize()
    assert QK.quant_panel_gemm.launches == n0 + 1 and y.dtype == x_dtype
    deq = F.dequantize_padded(codes, s, fmt)
    value = QK.quant_panel_gemm_plain(x, codes, s, bias, res,
                                      weight_format=fmt, block_k=128,
                                      out_dtype=torch.float32, epilogue=es)
    bound = K.gemm_error_bound(x, deq, bias=bias, residual=res, epilogue=es,
                               out_dtype=x_dtype, value=value)
    assert torch.all((y.float() - value.to(x_dtype).float()).abs() <= bound)
    assert bitexact.bit_identical(y, K.panel_gemm(x, deq, bias, res, **kw))
    assert bitexact.bit_identical(y, QK.quant_panel_gemm(
        x, codes, s, bias, res, weight_format=fmt, **kw))


@pytest.mark.parametrize("split_k", [2, 4])
@pytest.mark.parametrize("spec", [None, dict(glu="silu"),
                                  dict(bias=True, residual=True)], ids=_id)
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_splitk_kernel_matches_plain_and_the_fp32_kernel(
        cuda, fmt, spec, split_k):
    glu = spec is not None and "glu" in spec
    x, codes, s, bias, res, es = _operands(cuda, fmt, spec, 8, 1024,
                                           512 if glu else 256,
                                           torch.float32, seed=1)
    kw = dict(split_k=split_k, block_m=8, block_n=128, block_k=128,
              epilogue=es)
    n0 = QK.quant_panel_gemm_splitk.launches
    y = QK.quant_panel_gemm_splitk(x, codes, s, bias, res,
                                   weight_format=fmt, **kw)
    torch.cuda.synchronize()
    assert QK.quant_panel_gemm_splitk.launches == n0 + 1
    deq = F.dequantize_padded(codes, s, fmt)
    value = QK.quant_panel_gemm_splitk_plain(
        x, codes, s, bias, res, weight_format=fmt, split_k=split_k,
        block_k=128, epilogue=es)
    bound = K.gemm_error_bound(x, deq, bias=bias, residual=res, epilogue=es,
                               value=value)
    assert torch.all((y - value).abs() <= bound)
    assert bitexact.bit_identical(
        y, K.panel_gemm_splitk(x, deq, bias, res, **kw))


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_kernels_are_batch_invariant(cuda, fmt):
    x, codes, s, _, _, _ = _operands(cuda, fmt, None, 128, 1024, 384,
                                     torch.bfloat16, 2)
    kw = dict(weight_format=fmt, block_n=128, block_k=128)
    full = QK.quant_panel_gemm(x, codes, s, block_m=128, **kw)
    for m in (1, 8, 16, 77):
        assert bitexact.bit_identical(QK.quant_panel_gemm(
            x[:m].contiguous(), codes, s, block_m=1, **kw), full[:m]), m
    sk = QK.quant_panel_gemm_splitk(x, codes, s, split_k=2, block_m=8, **kw)
    assert bitexact.bit_identical(QK.quant_panel_gemm_splitk(
        x[5:13].contiguous(), codes, s, split_k=2, block_m=8, **kw),
        sk[5:13])


def test_card_packs_equal_cpu_packs(cuda):
    """The quantizers give the same codes and scales on the card as on the
    CPU (fixed-order group sums, true divisions)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    w = torch.randn((3, 1024, 640), generator=gen) * 0.02
    for fmt in FORMATS:
        cpu = F.quantize_pack(w, fmt, block_n=128, block_k=512,
                              measure=False, sparse=False)
        dev = F.quantize_pack(w.to(cuda), fmt, block_n=128, block_k=512,
                              measure=False, sparse=False)
        assert bitexact.bit_identical(dev.data, cpu.data)
        assert bitexact.bit_identical(dev.scales, cpu.scales)


def test_quant_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, codes, s, _, _, _ = _operands(cuda, "int8", None, 8, 256, 256,
                                     torch.float32)
    kw = dict(block_m=8, block_n=128, block_k=128)
    with pytest.raises(TypeError):                  # int8 codes as uint8
        QK.quant_panel_gemm(x, codes.view(torch.uint8), s,
                            weight_format="int8", **kw)
    with pytest.raises(TypeError):
        QK.quant_panel_gemm(x, codes, s.double(), weight_format="int8", **kw)
    with pytest.raises(ValueError):
        QK.quant_panel_gemm(x, codes.cpu(), s, weight_format="int8", **kw)
    with pytest.raises(ValueError):
        QK.quant_panel_gemm(x, codes, s, weight_format="int8", block_m=8,
                            block_n=128, block_k=64)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_serve_equals_generate_through_the_kernels(cuda, fmt):
    """Reduced deepseek-7b on quantized packs on the card: serve returns
    per-request generate's tokens through the dequant-fused kernel (and
    the fp32 kernel for the kept head)."""
    cfg = model_zoo.reduced_config(model_zoo.get_config("deepseek-7b"))
    eng = Engine(cfg, model_zoo.build(cfg, seed=0, device=cuda), max_len=64,
                 device=cuda, quant=fmt)
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab_size, n) for n in (9, 5, 17, 23)]
    n0, h0 = QK.quant_panel_gemm.launches, K.panel_gemm.launches
    want = [eng.generate(r[None], 6)[0][0].cpu().numpy() for r in reqs]
    outs, stats = eng.serve(reqs, batch_slots=2, max_new_tokens=6,
                            prefill_chunk=8, page_size=8,
                            check_invariants=True)
    for o, g in zip(outs, want):
        np.testing.assert_array_equal(o, g)
    assert QK.quant_panel_gemm.launches > n0 and K.panel_gemm.launches > h0
    assert stats.quant == fmt
