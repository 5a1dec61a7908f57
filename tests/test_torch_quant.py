"""Quantized packs and the error ledger of the PyTorch port against the JAX
reference (``repro.quant``), at reduced sizes on the CPU.

Contracts held here:

* int8 codes and scales equal the reference's bit for bit;
* ternary codes equal the reference's except where ``|w|`` lies within 8
  fp32 ulps of its group's threshold, and ternary scales within 8 ulps.
  The threshold and the scale are fp32 sums over a group's 128 rows; the
  port sums them in a fixed pairwise tree, XLA in an order of its own.
  Measured here: scales at most 3 ulps apart (seeds and shapes below),
  no code apart;
* the 2-bit byte layout, ``dequantize_padded`` on a carried pack, pack
  metadata, padding and fused split maps equal the reference's;
* stacked and per-layer packs are bit-identical inside the port;
* the sparse-ternary arm, not ported yet, refuses where the reference
  would compress;
* the error ledger's tolerances and probe equal the reference's, and it
  gates broken packs and their plans.

Plans and plan/execute are in ``test_torch_quant_gemm.py``, engines in
``test_torch_quant_model.py``, the kernels on the card in
``test_torch_quant_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import gemm as JG
from repro.quant import formats as JF
from repro.quant import ledger as JL
from repro_torch import gemm as TG
from repro_torch.core import bitexact
from repro_torch.core import packing as tpacking
from repro_torch.models import model_zoo as tzoo
from repro_torch.quant import formats as TF
from repro_torch.quant import ledger as TL

FORMATS = ("int8", "ternary")
ULPS = 8


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


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _near_threshold(w):
    """Elements whose |w| lies within ULPS fp32 ulps of their group's
    ternary threshold (the port's fp32 threshold)."""
    wt = _t(w)
    g, _ = TF._grouped(wt)
    k = wt.shape[-2]
    kg = g.shape[-3]
    counts = torch.full((kg, 1, 1), float(TF.GROUP_K))
    counts[-1] = float(k - (kg - 1) * TF.GROUP_K)
    delta = TF.TERNARY_DELTA * TF._group_sum(g.abs()) / counts
    ulp = torch.abs(torch.nextafter(delta, torch.full_like(delta, np.inf))
                    - delta)
    near = (g.abs() - delta).abs() <= ULPS * ulp
    return TF._ungroup(near, k).numpy()


SHAPES = [(300, 200), (2, 384, 64), (1024, 96)]


# ------------------------------------------------------------- quantizers
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_int8_codes_and_scales_bit_identical_to_reference(shape):
    w = _rand(np.random.default_rng(0), shape, 0.02)
    jq, js = JF.quantize_int8(jnp.asarray(w))
    tq, ts = TF.quantize_int8(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert bitexact.bit_identical(tq, np.asarray(jq))
    assert bitexact.bit_identical(ts, np.asarray(js))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ternary_codes_equal_and_scales_within_8_ulps(shape):
    w = _rand(np.random.default_rng(1), shape, 0.02)
    jq, js = JF.quantize_ternary(jnp.asarray(w))
    tq, ts = TF.quantize_ternary(_t(w))
    jq, js = np.asarray(jq), np.asarray(js)
    assert tq.shape == jq.shape and ts.shape == js.shape
    differ = tq.numpy() != jq
    assert not np.any(differ & ~_near_threshold(w))
    assert _ulps(ts.numpy(), js).max() <= ULPS
    assert set(np.unique(tq.numpy())) <= {-1, 0, 1}


def test_ternary_group_sums_are_a_fixed_tree():
    """Stacked and per-layer ternary packs are bit-identical inside the
    port: the group sums do not depend on the leading dims."""
    w = _rand(np.random.default_rng(2), (3, 384, 200), 0.05)
    stacked = TF.quantize_pack(_t(w), "ternary", block_n=128, block_k=256,
                               measure=False, sparse=False)
    for li in range(3):
        one = TF.quantize_pack(_t(w[li]), "ternary", block_n=128,
                               block_k=256, measure=False, sparse=False)
        assert bitexact.bit_identical(one.data, stacked.data[li])
        assert bitexact.bit_identical(one.scales, stacked.scales[li])
    g = torch.arange(128, dtype=torch.float32).reshape(1, 128, 1) + 0.1
    want = g[:, :64] + g[:, 64:]
    while want.shape[1] > 1:
        h = want.shape[1] // 2
        want = want[:, :h] + want[:, h:]
    assert bitexact.bit_identical(TF._group_sum(g), want)


@pytest.mark.parametrize("k,n", [(8, 5), (128, 64), (12, 1)])
def test_ternary_2bit_pack_round_trip_and_byte_layout(k, n):
    rng = np.random.default_rng(3)
    t = rng.integers(-1, 2, (k, n)).astype(np.int8)
    tb = TF.pack_ternary_codes(_t(t))
    jb = JF.pack_ternary_codes(jnp.asarray(t))
    assert tb.dtype == torch.uint8 and tuple(tb.shape) == (k // 4, n)
    assert bitexact.bit_identical(tb, np.asarray(jb))
    assert np.array_equal(TF.unpack_ternary_codes(tb).numpy(), t)
    # row 4r+i in bits [2i, 2i+2), stored as code + 1
    assert int(tb[0, 0]) == sum(int(t[i, 0] + 1) << (2 * i) for i in range(4))
    with pytest.raises(TF.QuantFormatError):
        TF.pack_ternary_codes(_t(t[:3]))


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_padded_bit_identical_on_a_carried_pack(fmt):
    w = _rand(np.random.default_rng(4), (300, 200), 0.05)
    jp = JF.quantize_pack(jnp.asarray(w), fmt, block_n=128, block_k=256,
                          measure=False, sparse=False)
    got = TF.dequantize_padded(_t(np.asarray(jp.data)),
                               _t(np.asarray(jp.scales)), fmt)
    want = np.asarray(JF.dequantize_padded(jp.data, jp.scales, fmt))
    assert bitexact.bit_identical(got, want)


# ------------------------------------------------------------------- packs
def _pack_pair(fmt, parts, **kw):
    """The port's ``pack``/``pack_fused(quant=)`` (measured by the ledger)
    and the reference's quantizer on the same weights."""
    rng = np.random.default_rng(5)
    ws = [_rand(rng, s, 0.05) for s in parts]
    if len(ws) == 1:
        tp = tpacking.pack(_t(ws[0]), quant=fmt, **kw)
        jp = JF.quantize_pack(jnp.asarray(ws[0]), fmt, measure=False, **kw)
    else:
        tp = tpacking.pack_fused([_t(w) for w in ws], quant=fmt, **kw)
        jp = JF.quantize_pack_fused([jnp.asarray(w) for w in ws], fmt,
                                    measure=False, **kw)
    return tp, jp


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("parts,kw", [
    (((300, 200),), dict(block_n=128, block_k=256)),      # ragged
    (((200, 300),), dict(block_n=256, block_k=128, transposed=True)),
    (((300, 128), (300, 64), (300, 64)), dict(block_n=512, block_k=2048)),
    (((300, 176), (300, 176)), dict(block_n=256, block_k=256)),
], ids=["ragged", "transposed", "fused-qkv", "fused-glu"])
def test_quantize_pack_layout_equals_reference(fmt, parts, kw):
    tp, jp = _pack_pair(fmt, parts, **kw)
    assert isinstance(tp, TF.QuantizedPackedWeight)
    assert (tp.n, tp.k, tp.block_n, tp.block_k, tp.n_splits, tp.fmt,
            tp.k_pad, tp.n_pad) == \
        (jp.n, jp.k, jp.block_n, jp.block_k, jp.n_splits, jp.fmt,
         jp.k_pad, jp.n_pad)
    assert tp.data.dtype == {"int8": torch.int8,
                             "ternary": torch.uint8}[fmt]
    assert tuple(tp.data.shape) == jp.data.shape
    assert tuple(tp.scales.shape) == jp.scales.shape
    jd, js = np.asarray(jp.data), np.asarray(jp.scales)
    if fmt == "int8":
        assert bitexact.bit_identical(tp.data, jd)
        assert bitexact.bit_identical(tp.scales, js)
    else:
        # codes equal away from the threshold (see the module docstring)
        tc = TF.unpack_ternary_codes(tp.data).numpy()
        jc = np.asarray(JF.unpack_ternary_codes(jp.data))
        assert (tc != jc).mean() <= 1e-3
        assert _ulps(tp.scales.numpy(), js).max() <= ULPS
        assert abs(tp.sparsity - jp.sparsity) <= 1e-3
    # padding dequantizes to exact zeros on both
    deq = TF.dequantize(tp).numpy()
    assert np.all(deq[tp.k:] == 0)
    assert np.all(np.asarray(JF.dequantize(jp))[jp.k:] == 0)


def test_sparse_arm_raises_not_ported():
    w = _rand(np.random.default_rng(6), (512, 128), 0.05)
    with pytest.raises(NotImplementedError):
        TF.quantize_pack(_t(w), "ternary", measure=False, sparse=True)
    with pytest.raises(TF.QuantFormatError):
        TF.quantize_pack(_t(w), "int8", measure=False, sparse=True)
    # half the K groups all zero: the reference's auto arm compresses
    w[128:384] = 0.0
    jp = JF.quantize_pack(jnp.asarray(w), "ternary", block_n=128,
                          block_k=128, measure=False)
    assert isinstance(jp, JF.SparseTernaryPackedWeight)
    with pytest.raises(NotImplementedError):
        TF.quantize_pack(_t(w), "ternary", block_n=128, block_k=128,
                         measure=False)
    dense = TF.quantize_pack(_t(w), "ternary", block_n=128, block_k=128,
                             measure=False, sparse=False)
    assert TF.zero_group_fraction(dense) == 0.5
    with pytest.raises(ValueError):
        tpacking.pack(_t(w), sparse=True)


# --------------------------------------------------- ledger and the gates
def test_ledger_tolerances_and_measure_match_reference():
    assert TL.TOLERANCES == JL.TOLERANCES and TL.PROBE_M == JL.PROBE_M
    w = _rand(np.random.default_rng(50), (384, 256), 0.05)
    for fmt in FORMATS:
        jp = JF.quantize_pack(jnp.asarray(w), fmt, block_n=128,
                              block_k=128, measure=False, sparse=False)
        tp = tzoo._convert_pack(jp, torch.device("cpu"))
        je = JL.measure(jnp.asarray(w), jp, enforce=True)
        te = TL.measure(_t(w), tp, enforce=True)
        assert (te.n, te.k, te.fmt, te.tol, te.probe_m) == \
            (je.n, je.k, je.fmt, je.tol, je.probe_m)
        # same pack, same probe: only the fp32 dots' orders differ
        assert te.max_rel == pytest.approx(je.max_rel, rel=1e-3)
        assert te.within_tol and TL.lookup(256, 384, fmt) == te
    assert [e.fmt for e in TL.entries()] == list(FORMATS)


def test_ledger_gate_rejects_a_broken_pack_and_its_plans():
    w = _t(_rand(np.random.default_rng(51), (256, 256), 0.05))
    qpw = TF.quantize_pack(w, "int8", block_n=128, block_k=128)
    p = TG.plan_for_packed(8, qpw)
    assert TG.validate_plan(p)
    import dataclasses
    broken = dataclasses.replace(qpw, scales=qpw.scales * 1.5)
    with pytest.raises(TL.QuantToleranceError):
        TL.measure(w, broken, enforce=True)
    assert not TL.lookup(256, 256, "int8").within_tol
    assert not TG.validate_plan(p)
    TL.clear()
    assert TL.lookup(256, 256, "int8") is None
