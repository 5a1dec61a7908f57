"""The port's hand-written CUDA kernels on the card.

Every case carries the ``gpu`` marker and skips where there is no card
(the kernels have no CPU mode). The file imports only torch and the port,
so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitexact
from repro_torch.kernels import panel_gemm as K
from repro_torch.models import model_zoo
from repro_torch.runtime.serve_loop import Engine

pytestmark = pytest.mark.gpu

EPILOGUES = [
    None,
    dict(bias=True),
    dict(act="silu"),
    dict(act="gelu"),
    dict(act="tanh"),
    dict(softcap=20.0),
    dict(residual=True),
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


def _operands(dev, spec, m, k, n, x_dtype, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    glu = spec is not None and "glu" in spec
    x = torch.randn((m, k), generator=gen, device=dev).to(x_dtype)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    bias = (torch.randn((n,), generator=gen, device=dev)
            if spec and spec.get("bias") else None)
    res = (torch.randn((m, n // 2 if glu else n), generator=gen, device=dev)
           if spec and spec.get("residual") else None)
    return x, w, bias, res, (K.EpilogueSpec(**spec) if spec else None)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", EPILOGUES, ids=_id)
def test_panel_gemm_kernel_matches_plain_version(cuda, spec, x_dtype):
    """Within ``gemm_error_bound`` of the plain version, and bitwise equal
    from launch to launch."""
    glu = spec is not None and "glu" in spec
    x, w, bias, res, es = _operands(cuda, spec, 64, 512, 512 if glu else 256,
                                    x_dtype)
    n0 = K.panel_gemm.launches
    y = K.panel_gemm(x, w, bias, res, block_m=64, block_n=128, block_k=128,
                     epilogue=es)
    torch.cuda.synchronize()
    assert K.panel_gemm.launches == n0 + 1 and y.dtype == x_dtype
    value = K.panel_gemm_plain(x, w, bias, res, block_k=128,
                               out_dtype=torch.float32, epilogue=es)
    bound = K.gemm_error_bound(x, w, bias=bias, residual=res, epilogue=es,
                               out_dtype=x_dtype, value=value)
    assert torch.all((y.float() - value.to(x_dtype).float()).abs() <= bound)
    again = K.panel_gemm(x, w, bias, res, block_m=64, block_n=128,
                         block_k=128, epilogue=es)
    assert bitexact.bit_identical(y, again)


@pytest.mark.parametrize("split_k", [2, 4])
@pytest.mark.parametrize("spec", [None, dict(glu="silu"),
                                  dict(bias=True, residual=True)], ids=_id)
def test_splitk_kernel_matches_plain_version(cuda, spec, split_k):
    glu = spec is not None and "glu" in spec
    x, w, bias, res, es = _operands(cuda, spec, 8, 1024, 512 if glu else 256,
                                    torch.float32, seed=1)
    n0 = K.panel_gemm_splitk.launches
    y = K.panel_gemm_splitk(x, w, bias, res, split_k=split_k, block_m=8,
                            block_n=128, block_k=128, epilogue=es)
    torch.cuda.synchronize()
    assert K.panel_gemm_splitk.launches == n0 + 1
    value = K.panel_gemm_splitk_plain(x, w, bias, res, split_k=split_k,
                                      block_k=128, epilogue=es)
    bound = K.gemm_error_bound(x, w, bias=bias, residual=res, epilogue=es,
                               value=value)
    assert torch.all((y - value).abs() <= bound)


def test_kernels_are_batch_invariant(cuda):
    """A row's result does not depend on M or on the other rows: the K sum
    runs in ascending order in one fp32 accumulator whatever the tile."""
    x, w, _, _, _ = _operands(cuda, None, 128, 1024, 384, torch.bfloat16, 2)
    full = K.panel_gemm(x, w, block_m=128, block_n=128, block_k=128)
    for m in (1, 8, 16, 77):
        assert bitexact.bit_identical(
            K.panel_gemm(x[:m].contiguous(), w, block_m=1, block_n=128,
                         block_k=128), full[:m]), m
    sk = K.panel_gemm_splitk(x, w, split_k=2, block_m=8, block_n=128,
                             block_k=128)
    assert bitexact.bit_identical(
        K.panel_gemm_splitk(x[5:13].contiguous(), w, split_k=2, block_m=8,
                            block_n=128, block_k=128), sk[5:13])


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, w, _, _, _ = _operands(cuda, None, 8, 256, 256, torch.float32)
    kw = dict(block_m=8, block_n=128, block_k=128)
    with pytest.raises(TypeError):
        K.panel_gemm(x.half(), w, **kw)
    with pytest.raises(TypeError):
        K.panel_gemm(x, w.double(), **kw)
    with pytest.raises(ValueError):
        K.panel_gemm(x, w.T.contiguous().T, **kw)       # not contiguous
    with pytest.raises(ValueError):
        K.panel_gemm(x, w.cpu(), **kw)                  # another device
    with pytest.raises(ValueError):
        K.panel_gemm(x[:, :200].contiguous(), w[:200], **kw)


def test_serve_equals_generate_through_the_kernels(cuda):
    """Reduced deepseek-7b on the card: serve (2 slots, chunked prefill,
    paged decode) returns per-request generate's tokens through the
    kernel."""
    cfg = model_zoo.reduced_config(model_zoo.get_config("deepseek-7b"))
    eng = Engine(cfg, model_zoo.build(cfg, seed=0, device=cuda), max_len=64,
                 device=cuda)
    assert eng.backend == "cuda"
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, cfg.vocab_size, n) for n in (9, 5, 17, 23)]
    n0, s0 = K.panel_gemm.launches, K.panel_gemm_splitk.launches
    want = [eng.generate(r[None], 6)[0][0].cpu().numpy() for r in reqs]
    outs, _ = eng.serve(reqs, batch_slots=2, max_new_tokens=6,
                        prefill_chunk=8, page_size=8, check_invariants=True)
    for o, g in zip(outs, want):
        np.testing.assert_array_equal(o, g)
    assert K.panel_gemm.launches > n0
    # at these widths every padded K is one 128-deep block, so the decode
    # arm resolves split_k = 1 and the split-K kernel is not on this path
    assert K.panel_gemm_splitk.launches == s0
