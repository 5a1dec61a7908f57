"""Numerics foundations of the PyTorch port against the JAX reference.

The same numpy inputs (from ``np.random.default_rng``) go through
``repro`` and ``repro_torch``: the activation table, the epilogue, the
blocked and split-K GEMM oracles, the split-K combine tree, the tile
footprint model and the bit-exactness harness.  Tolerances are stated
beside each comparison with their reason.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitexact as jbitexact
from repro.kernels import panel_gemm as jpg
from repro.kernels import ref as jref
from repro_torch.core import bitexact as tbitexact
from repro_torch.kernels import panel_gemm as tpg
from repro_torch.kernels import ref as tref

U = 2.0 ** -24          # fp32 unit roundoff

# Elementwise transcendental ops: the port rounds the float64 value once
# (correctly rounded but for ties), XLA's fp32 exp/tanh/logistic are
# accurate to a few ulps, so the two agree within 4 fp32 ulps.  The ulps
# are those of the largest intermediate: tanh-form gelu evaluates
# 0.5 * x * (1 + tanh(.)), which cancels for x << 0, so its fp32 error is
# relative to |x| and not to the (tiny) result.
ACT_RTOL = 4 * 2.0 ** -23


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many tiny products; with several test
    workers sharing the machine, torch's thread pool only adds contention
    (its idle threads spin while the workers' Python runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EPILOGUES = [
    dict(bias=True),
    dict(act="silu"),
    dict(act="gelu"),
    dict(act="tanh"),
    dict(softcap=30.0),
    dict(residual=True),
    dict(bias=True, act="gelu", softcap=15.0, residual=True),
    dict(glu="silu"),
    dict(glu="gelu", bias=True, residual=True),
    dict(glu="silu", softcap=5.0),
]


def _ids(specs):
    return ["-".join(f"{k}={v}" for k, v in s.items()) for s in specs]


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# -------------------------------------------------------------- activations
@pytest.mark.parametrize("name", ["silu", "gelu", "tanh"])
def test_act_fn_matches_reference(name):
    rng = np.random.default_rng(0)
    x = np.concatenate([_rand(rng, (4096,), 4.0),
                        np.linspace(-20, 20, 1001, dtype=np.float32)])
    got = _np(tpg.act_fn(name)(_t(x)))
    want = _np(jpg.act_fn(name)(jnp.asarray(x)))
    scale = np.maximum(np.abs(want), np.abs(x) if name == "gelu" else 0.0)
    assert np.all(np.abs(got - want) <= ACT_RTOL * scale), name


def test_act_fn_rejects_unknown_names():
    with pytest.raises(ValueError):
        tpg.act_fn("relu")
    with pytest.raises(ValueError):
        tpg.EpilogueSpec(act="relu")
    with pytest.raises(ValueError):
        tpg.EpilogueSpec(act="silu", glu="silu")


def test_gelu_is_the_tanh_form():
    """The port's gelu is the reference's hand-written tanh form (with
    x*x*x), not torch's erf gelu: at x = 1 the two forms differ in the
    fourth decimal."""
    x = torch.tensor([1.0])
    tanh_form = 0.5 * (1.0 + np.tanh(0.7978845608028654 * (1 + 0.044715)))
    assert abs(float(tpg.act_fn("gelu")(x)) - tanh_form) < 1e-7
    assert abs(float(torch.nn.functional.gelu(x)) - tanh_form) > 1e-5


# ----------------------------------------------------------------- epilogue
def _epilogue_operands(rng, spec, m, n):
    acc = _rand(rng, (m, n), 3.0)
    bias = _rand(rng, (n,)) if spec.get("bias") else None
    n_out = n // 2 if spec.get("glu") else n
    res = _rand(rng, (m, n_out)) if spec.get("residual") else None
    return acc, bias, res


@pytest.mark.parametrize("spec", EPILOGUES, ids=_ids(EPILOGUES))
def test_apply_epilogue_matches_reference(spec):
    """Same fp32 ops in the same order (bias -> act or glu -> softcap ->
    residual): every step is one rounding on each side, and each
    transcendental step adds at most ACT_RTOL, so 3 * ACT_RTOL of the
    magnitude covers the chain."""
    rng = np.random.default_rng(1)
    acc, bias, res = _epilogue_operands(rng, spec, 16, 256)
    got = tpg.apply_epilogue(_t(acc), tpg.EpilogueSpec(**spec),
                             bias=None if bias is None else _t(bias),
                             residual=None if res is None else _t(res))
    want = jpg.apply_epilogue(
        jnp.asarray(acc), jpg.EpilogueSpec(**spec),
        bias=None if bias is None else jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res))
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = np.abs(acc).max() ** 2 + 1.0
    np.testing.assert_allclose(got, want, rtol=3 * ACT_RTOL,
                               atol=3 * ACT_RTOL * scale)


def test_apply_epilogue_glu_on_split_halves_equals_full_width():
    """``apply_epilogue`` on the full fused width is ``apply_epilogue_glu``
    on its halves, bit for bit (one definition)."""
    rng = np.random.default_rng(2)
    spec = tpg.EpilogueSpec(glu="gelu", bias=True, residual=True,
                            softcap=7.0)
    acc, bias, res = (_t(a) for a in _epilogue_operands(
        rng, dict(glu="gelu", bias=True, residual=True), 8, 256))
    full = tpg.apply_epilogue(acc, spec, bias=bias, residual=res)
    halves = tpg.apply_epilogue_glu(acc[:, :128], acc[:, 128:], spec,
                                    bias_g=bias[:128], bias_u=bias[128:],
                                    residual=res)
    assert tbitexact.bit_identical(full, halves)
    jfull = jpg.apply_epilogue_glu(
        jnp.asarray(acc[:, :128].numpy()), jnp.asarray(acc[:, 128:].numpy()),
        jpg.EpilogueSpec(glu="gelu", bias=True, residual=True, softcap=7.0),
        bias_g=jnp.asarray(bias[:128].numpy()),
        bias_u=jnp.asarray(bias[128:].numpy()),
        residual=jnp.asarray(res.numpy()))
    np.testing.assert_allclose(_np(full), _np(jfull), rtol=3 * ACT_RTOL,
                               atol=3 * ACT_RTOL * 100)


def test_softcap_multiplies_by_the_reciprocal():
    """Softcap is ``cap * tanh(x * (1/cap))`` with 1/cap rounded once, as
    the reference (and the CUDA epilogue) compute it."""
    x = torch.tensor([123.456, -77.0, 3.0e4], dtype=torch.float32)
    cap = 30.0
    y = tpg.apply_epilogue(x, tpg.EpilogueSpec(softcap=cap))
    rcp = torch.tensor(1.0 / cap, dtype=torch.float32)
    want = cap * torch.tanh((x * rcp).double()).float()
    assert tbitexact.bit_identical(y, want)


# ---------------------------------------------------------- GEMM oracles
def gemm_bound(x, w):
    """Two fp32 sums of the same K products in any orders differ by at most
    2 * K * u * (|x| @ |w|) elementwise (the standard summation bound, once
    for each side)."""
    k = x.shape[1]
    return 2.0 * k * U * (np.abs(x).astype(np.float64)
                          @ np.abs(w).astype(np.float64))


@pytest.mark.parametrize("m,k,n,block_k", [(8, 256, 128, 128),
                                           (16, 512, 384, 256),
                                           (5, 384, 256, 128)])
def test_gemm_blocked_matches_reference(m, k, n, block_k):
    rng = np.random.default_rng(3)
    x, w = _rand(rng, (m, k)), _rand(rng, (k, n))
    got = _np(tref.gemm_blocked(_t(x), _t(w), block_k))
    want = _np(jref.gemm_blocked(jnp.asarray(x), jnp.asarray(w), block_k))
    assert np.all(np.abs(got - want) <= gemm_bound(x, w))


@pytest.mark.parametrize("split_k", [1, 2, 4])
def test_gemm_splitk_matches_reference(split_k):
    rng = np.random.default_rng(4)
    x, w = _rand(rng, (8, 1024)), _rand(rng, (1024, 256))
    got = _np(tref.gemm_splitk(_t(x), _t(w), 128, split_k))
    want = _np(jref.gemm_splitk(jnp.asarray(x), jnp.asarray(w), 128,
                                split_k))
    assert np.all(np.abs(got - want) <= gemm_bound(x, w))


def test_gemm_splitk_of_one_slice_is_blocked_exactly():
    rng = np.random.default_rng(5)
    x, w = _t(_rand(rng, (8, 512))), _t(_rand(rng, (512, 128)))
    assert tbitexact.bit_identical(tref.gemm_splitk(x, w, 128, 1),
                                   tref.gemm_blocked(x, w, 128))


def test_gemm_oracles_reject_ragged_k():
    x, w = torch.zeros((8, 300)), torch.zeros((300, 128))
    with pytest.raises(ValueError):
        tref.gemm_blocked(x, w, 128)
    with pytest.raises(ValueError):
        tref.gemm_splitk(torch.zeros((8, 512)), torch.zeros((512, 128)),
                         256, 4)


# ------------------------------------------------------- split-K combine
class _Sym:
    """A value that records how it was summed."""

    def __init__(self, expr):
        self.expr = expr

    def __add__(self, other):
        return _Sym(f"({self.expr}+{other.expr})")


TREES = {
    1: "p0",
    2: "(p0+p1)",
    3: "((p0+p1)+p2)",
    4: "((p0+p1)+(p2+p3))",
    5: "(((p0+p1)+(p2+p3))+p4)",
    8: "(((p0+p1)+(p2+p3))+((p4+p5)+(p6+p7)))",
}


@pytest.mark.parametrize("n", sorted(TREES))
def test_splitk_combine_tree_order(n):
    parts = [_Sym(f"p{i}") for i in range(n)]
    assert tpg.splitk_combine(parts).expr == TREES[n]
    # the reference sums in exactly the same tree
    assert jpg.splitk_combine([_Sym(f"p{i}") for i in range(n)]).expr \
        == TREES[n]


def test_splitk_combine_is_not_a_left_fold():
    """fp32 values where the tree and a left fold disagree: the port
    returns the tree's answer, on a list and on a stacked tensor."""
    p = torch.tensor([1e8, 1.0, -1e8, 1.0], dtype=torch.float32)[:, None]
    stacked = p[:, :, None]                           # [4, 1, 1]
    tree = (p[0] + p[1]) + (p[2] + p[3])
    fold = ((p[0] + p[1]) + p[2]) + p[3]
    assert float(tree) != float(fold)
    assert float(tpg.splitk_combine(list(p))) == float(tree)
    assert float(tpg.splitk_combine(stacked)) == float(tree)
    with pytest.raises(ValueError):
        tpg.splitk_combine([])


# ------------------------------------------------------- footprint model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("glu", [False, True])
@pytest.mark.parametrize("split_k", [1, 2, 8])
def test_vmem_bytes_equals_reference(dtype, glu, split_k):
    """The policy clamps blocks against this model, so the port's value
    must equal the reference's exactly for plans to match."""
    tspec = tpg.EpilogueSpec(glu="silu") if glu else None
    jspec = jpg.EpilogueSpec(glu="silu") if glu else None
    for bm, bn, bk in [(128, 512, 2048), (8, 512, 1024), (64, 256, 512),
                       (128, 128, 128)]:
        assert tpg.vmem_bytes(bm, bn, bk, getattr(torch, dtype),
                              epilogue=tspec, split_k=split_k) == \
            jpg.vmem_bytes(bm, bn, bk, getattr(jnp, dtype), epilogue=jspec,
                           split_k=split_k)


def test_block_constants_equal_reference():
    for name in ("DEFAULT_BLOCK_M", "DEFAULT_BLOCK_N", "DEFAULT_BLOCK_K",
                 "DECODE_BLOCK_M", "VMEM_BUDGET"):
        assert getattr(tpg, name) == getattr(jpg, name), name


# --------------------------------------------------------- bit-exactness
def test_bitexact_report_matches_reference():
    rng = np.random.default_rng(6)
    a = _rand(rng, (64, 3000))
    b = a.copy()
    b[::7] += 1e-3
    for x, y in [(a, a), (a, b)]:
        got = tbitexact.report(_t(x), _t(y))
        want = jbitexact.report(x, y)
        assert got["bit_exact"] == want["bit_exact"]
        assert got["max_abs_diff_997"] == pytest.approx(
            want["max_abs_diff_997"], abs=1e-12)
        assert got["max_abs_diff_1023"] == pytest.approx(
            want["max_abs_diff_1023"], abs=1e-12)
    np.testing.assert_array_equal(tbitexact.sampled(_t(a)),
                                  np.asarray(jbitexact.sampled(a)))
    assert tbitexact.COPRIME_STRIDES == (997, 1023)


def test_bit_identical_sees_dtype_shape_and_signed_zero():
    z = torch.zeros(4)
    assert tbitexact.bit_identical(z, z.clone())
    assert not tbitexact.bit_identical(z, -z)          # -0.0 has other bits
    assert not tbitexact.bit_identical(z, z.double())
    assert not tbitexact.bit_identical(z, z[:3])
    bf = torch.ones(4, dtype=torch.bfloat16)
    assert tbitexact.bit_identical(bf, bf.clone())
    assert not tbitexact.bit_identical(bf, bf + bf.new_tensor(2 ** -7))
