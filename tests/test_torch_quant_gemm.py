"""Quantized plans and plan/execute of the PyTorch port against the JAX
reference (``repro.gemm`` with ``weight_format``), at reduced sizes on the
CPU.

* plans equal the reference's field by field, fused and unfused, at
  prefill and decode, for both formats (the unfused ``w_gate``/``w_up``
  decode plans split K in 2: the kernel-4 path);
* the tile budget with a quantized weight equals the reference's;
* ``execute`` on the ``plain`` backend, on the reference's own packs
  carried across, agrees with the reference's ``execute`` within the GEMM
  bound on the dequantized weight;
* the plain dequant-fused versions equal ``panel_gemm``'s plain versions
  on the dequantized weight bit for bit (the ``quant_gate`` law);
* a backend without ``run_quant`` rejects quantized plans.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import gemm as JG
from repro.quant import formats as JF
from repro_torch import gemm as TG
from repro_torch.configs.deepseek_7b import CONFIG as DS7B
from repro_torch.core import bitexact
from repro_torch.core import packing as tpacking
from repro_torch.kernels import panel_gemm as K
from repro_torch.quant import formats as TF
from repro_torch.quant import kernels as QK
from repro_torch.quant import ledger as TL

FORMATS = ("int8", "ternary")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many tiny products; with several test
    workers sharing the machine, torch's thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_state():
    JG.plan_cache_clear()
    TG.plan_cache_clear()
    TL.clear()
    yield
    JG.plan_cache_clear()
    TG.plan_cache_clear()
    TL.clear()


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -------------------------------------------------------------------- plans
_PLAN_FIELDS = ("m", "n", "k", "block_m", "block_n", "block_k", "pack",
                "lever", "split_k", "decode", "vmem_clamped", "occupancy",
                "t_pred", "fused_n_splits", "weight_format", "dtype")


def _same_plan(tp, jp):
    for f in _PLAN_FIELDS:
        assert getattr(tp, f) == getattr(jp, f), (f, tp, jp)


def _ds7b_packs():
    """(name, k, parts, glu pack/execute, residual) of deepseek-7b, fused
    and unfused."""
    d, f = DS7B.d_model, DS7B.d_ff
    h = DS7B.num_heads * DS7B.head_dim
    kv = DS7B.num_kv_heads * DS7B.head_dim
    return {"wqkv": (d, (h, kv, kv), False, False),
            "wo": (h, (d,), False, False),
            "w_gate_up": (d, (f, f), True, False),
            "w_down": (f, (d,), False, True),
            "w_gate": (d, (f,), False, False),
            "w_up": (d, (f,), False, False),
            "wq": (d, (h,), False, False)}


# decode split-K of the quantized packs at their own blocks (the reference
# policy's, probed on the CPU): the unfused gate and up split in 2
DS7B_QUANT_SPLIT = {"wqkv": 1, "wo": 1, "w_gate_up": 1, "w_down": 1,
                    "w_gate": 2, "w_up": 2, "wq": 1}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", list(DS7B_QUANT_SPLIT))
def test_deepseek_7b_quant_plans_equal_reference(fmt, name):
    k, parts, glu, residual = _ds7b_packs()[name]
    specs = {}
    for G in (TG, JG):
        specs[G] = (G.EpilogueSpec(glu=DS7B.act) if glu else
                    G.EpilogueSpec(residual=True) if residual else None)
    n_log = sum(parts)
    tb = TG.pack_blocks(n_log, k, m_hint=128, weight_format=fmt,
                        epilogue=specs[TG] if glu else None)
    jb = JG.pack_blocks(n_log, k, m_hint=128, weight_format=fmt,
                        epilogue=specs[JG] if glu else None)
    assert tb == jb
    bn = min(tpacking.fit_block(p, tb[0]) for p in parts)
    n = sum(-(-p // bn) * bn for p in parts)
    splits = parts if len(parts) > 1 else ()
    for m, decode in ((128, False), (1, True), (2, True), (4, True),
                      (8, True)):
        kw = dict(block_n=bn, block_k=tb[1], fused_n_splits=splits,
                  decode=decode, weight_format=fmt)
        tp = TG.plan(m, n, k, pack=TG.PACK_PREPACKED, epilogue=specs[TG],
                     **kw)
        jp = JG.plan(m, n, k, pack=JG.PACK_PREPACKED, backend="interpret",
                     epilogue=specs[JG], **kw)
        _same_plan(tp, jp)
        assert tp.quantized and tp.weight_format == fmt
        assert tp.split_k == (DS7B_QUANT_SPLIT[name] if decode else 1)


def test_plan_for_packed_carries_the_format_and_refuses_percall():
    w = _t(_rand(np.random.default_rng(7), (512, 256), 0.05))
    for fmt in FORMATS:
        qpw = tpacking.pack(w, quant=fmt, block_n=128, block_k=256)
        p = TG.plan_for_packed(8, qpw)
        assert (p.weight_format, p.dtype, p.block_n, p.block_k, p.pack) == \
            (fmt, "float32", 128, 256, TG.PACK_PREPACKED)
        assert "weight_format=" + fmt in p.describe()
        with pytest.raises(ValueError):
            TG.plan(8, 256, 512, weight_format=fmt, pack=TG.PACK_PERCALL)
        # a quantized plan never runs a raw weight, nor an fp32 plan a pack
        with pytest.raises(TG.PlanMismatchError):
            TG.execute(p, torch.zeros(8, 512), w)
        fp = TG.plan(8, 256, 512, block_n=128, block_k=256,
                     pack=TG.PACK_PREPACKED)
        with pytest.raises(TG.PlanMismatchError):
            TG.execute(fp, torch.zeros(8, 512), qpw)
    with pytest.raises(TF.QuantFormatError):
        TG.plan(8, 256, 512, weight_format="int4")


def test_quant_tile_budget_equals_reference():
    from repro.kernels import panel_gemm as JK
    for fmt in ("fp32",) + FORMATS:
        for glu in (False, True):
            for split in (1, 4):
                ts = K.EpilogueSpec(glu="silu") if glu else None
                js = JK.EpilogueSpec(glu="silu") if glu else None
                assert K.vmem_bytes(128, 512, 2048, torch.float32,
                                    epilogue=ts, weight_format=fmt,
                                    split_k=split) == \
                    JK.vmem_bytes(128, 512, 2048, jnp.float32, epilogue=js,
                                  weight_format=fmt, split_k=split)
        assert TF.weight_itemsize(fmt) == JF.weight_itemsize(fmt)


# ------------------------------------------------------------------ execute
EPILOGUES = [
    None,
    dict(bias=True, act="gelu"),
    dict(softcap=20.0, residual=True),
    dict(glu="silu"),
    dict(glu="gelu", bias=True, residual=True),
]
M, KD, NH = 12, 512, 256


def _spec_id(s):
    return "none" if s is None else "-".join(f"{k}={v}" for k, v in s.items())


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("split_k", [1, 2])
@pytest.mark.parametrize("spec", EPILOGUES, ids=_spec_id)
def test_execute_quant_plain_matches_reference(fmt, split_k, spec):
    """The port's ``plain`` run on the reference's own pack (carried across)
    against the reference's ``execute`` (``xla``: dequantize, then one
    dot), within the GEMM bound on the dequantized weight."""
    rng = np.random.default_rng(20 + split_k)
    glu = spec is not None and "glu" in spec
    parts = [_rand(rng, (KD, NH), KD ** -0.5) for _ in range(2 if glu else 1)]
    x = _rand(rng, (M, KD))
    n_out = NH
    bias = ([_rand(rng, (NH,)) for _ in parts]
            if spec and spec.get("bias") else None)
    res = _rand(rng, (M, n_out)) if spec and spec.get("residual") else None
    if glu:
        jp = JF.quantize_pack_fused([jnp.asarray(p) for p in parts], fmt,
                                    block_n=128, block_k=128, measure=False,
                                    sparse=False)
    else:
        jp = JF.quantize_pack(jnp.asarray(parts[0]), fmt, block_n=128,
                              block_k=128, measure=False, sparse=False)
    tp = TF.QuantizedPackedWeight(
        data=_t(np.asarray(jp.data)), n=jp.n, k=jp.k, block_n=jp.block_n,
        block_k=jp.block_k, n_splits=jp.n_splits,
        scales=_t(np.asarray(jp.scales)), fmt=fmt, sparsity=jp.sparsity)
    outs = []
    for G, pw, arr in ((TG, tp, _t), (JG, jp, jnp.asarray)):
        es = G.EpilogueSpec(**spec) if spec else None
        kw = {} if G is TG else {"backend": "xla"}
        p = G.plan(M, pw.n, pw.k, block_n=pw.block_n, block_k=pw.block_k,
                   pack=G.PACK_PREPACKED, epilogue=es,
                   fused_n_splits=pw.n_splits, weight_format=fmt,
                   split_k=split_k, **kw)
        b = None
        if bias is not None:
            b = [arr(v) for v in bias] if glu else arr(bias[0])
        y = G.execute(p, arr(x), pw, bias=b,
                      residual=None if res is None else arr(res))
        outs.append(np.asarray(y, np.float32))
    deq = TF.dequantize(tp)
    tspec = TG.EpilogueSpec(**spec) if spec else None
    bound = K.gemm_error_bound(
        _t(x), deq[:KD],
        bias=None if bias is None else _t(np.concatenate(bias)),
        residual=None if res is None else _t(res), epilogue=tspec,
        out_dtype=torch.float32).numpy()
    assert outs[0].shape == outs[1].shape == (M, n_out)
    assert np.all(np.abs(outs[0] - outs[1]) <= bound)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("split_k", [1, 2, 4])
@pytest.mark.parametrize("spec", [None, dict(bias=True, act="silu",
                                             softcap=8.0, residual=True),
                                  dict(glu="gelu", bias=True)],
                         ids=_spec_id)
def test_plain_quant_gemm_is_plain_panel_gemm_on_the_dequantized_weight(
        fmt, split_k, spec):
    """The law the port's ``quant_gate`` holds, on the plain versions:
    bit for bit the fp32 plain path on ``dequantize_padded``."""
    rng = np.random.default_rng(30 + split_k)
    glu = spec is not None and "glu" in spec
    n = 512 if glu else 256
    w = _t(_rand(rng, (1024, n), 1024 ** -0.5))
    q, s = TF.quantize(w, fmt)
    data = TF.pack_ternary_codes(q) if fmt == "ternary" else q
    x = _t(_rand(rng, (8, 1024)))
    es = K.EpilogueSpec(**spec) if spec else None
    bias = _t(_rand(rng, (n,))) if spec and spec.get("bias") else None
    res = (_t(_rand(rng, (8, 256)))
           if spec and spec.get("residual") else None)
    deq = TF.dequantize_padded(data, s, fmt)
    if split_k > 1:
        y = QK.quant_panel_gemm_splitk(
            x, data, s, bias, res, weight_format=fmt, split_k=split_k,
            block_m=8, block_n=128, block_k=128, epilogue=es)
        want = K.panel_gemm_splitk_plain(x, deq, bias, res, split_k=split_k,
                                         block_k=128, epilogue=es)
    else:
        y = QK.quant_panel_gemm(x, data, s, bias, res, weight_format=fmt,
                                block_m=8, block_n=128, block_k=256,
                                epilogue=es)
        want = K.panel_gemm_plain(x, deq, bias, res, block_k=256,
                                  epilogue=es)
    assert bitexact.bit_identical(y, want)
    assert QK.quant_gate(8, 128, 256, fmt, epilogue=es, split_k=split_k)


def test_quant_wrappers_on_cpu_run_plain_without_counting():
    rng = np.random.default_rng(40)
    w = _t(_rand(rng, (256, 256), 0.05))
    q, s = TF.quantize(w, "int8")
    x = _t(_rand(rng, (8, 256)))
    n0 = QK.quant_panel_gemm.launches
    s0 = QK.quant_panel_gemm_splitk.launches
    QK.quant_panel_gemm(x, q, s, weight_format="int8", block_m=8,
                        block_n=128, block_k=128)
    QK.quant_panel_gemm_splitk(x, q, s, weight_format="int8", split_k=2,
                               block_m=8, block_n=128, block_k=128)
    assert (QK.quant_panel_gemm.launches,
            QK.quant_panel_gemm_splitk.launches) == (n0, s0)
    with pytest.raises(ValueError):              # block_k off the groups
        QK.quant_panel_gemm(x, q, s, weight_format="int8", block_m=8,
                            block_n=128, block_k=64)
    with pytest.raises(ValueError):              # scales of another shape
        QK.quant_panel_gemm(x, q, s[:, :128], weight_format="int8",
                            block_m=8, block_n=128, block_k=128)
    with pytest.raises(ValueError):              # ternary codes: K/4 rows
        QK.quant_panel_gemm(x, q, s, weight_format="ternary", block_m=8,
                            block_n=128, block_k=128)


def test_validated_quant_plans_pass_the_gate():
    for fmt in FORMATS:
        for spec in (None, TG.EpilogueSpec(glu="silu", residual=True)):
            for s in (1, 2):
                p = TG.plan(8, 256, 512, block_n=128, block_k=128,
                            epilogue=spec, split_k=s, weight_format=fmt,
                            validate=True)
                assert p.validated and TG.validate_plan(p)


def test_backend_without_run_quant_rejects_quantized_plans():
    from repro_torch.gemm import backends as TB
    name = "fp32-only-test"
    TG.register_backend(name, TB._run_plain, overwrite=True)
    try:
        w = _t(_rand(np.random.default_rng(52), (256, 256), 0.05))
        qpw = TF.quantize_pack(w, "ternary", block_n=128, block_k=128)
        p = TG.plan_for_packed(8, qpw, backend=name)
        with pytest.raises(TG.PlanMismatchError, match="run_quant"):
            TG.execute(p, torch.zeros(8, 256), qpw)
        fp = TG.plan(8, 256, 256, backend=name, block_n=128, block_k=128,
                     pack=TG.PACK_PREPACKED)
        TG.execute(fp, torch.zeros(8, 256), tpacking.pack(
            w, block_n=128, block_k=128))
        for b in ("cuda", "plain", "torch"):
            assert TG.get_backend(b).run_quant is not None
    finally:
        TB._REGISTRY.pop(name, None)
