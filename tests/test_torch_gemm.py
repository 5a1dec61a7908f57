"""Packing, plans and plan/execute of the PyTorch port against the JAX
reference.

* packs equal the reference's bit for bit (packing is pure layout);
* plans (lever, pack, block triple, split-K) equal the reference's on the
  paper's twelve prefill shapes and on deepseek-7b's five packs;
* ``execute`` on the port's ``plain`` backend agrees with JAX ``execute``
  on ``interpret`` within the GEMM bound, across the epilogue grid, fused
  packs and split-K 1/2/4;
* the plain version is deterministic and batch-invariant.

The kernels themselves are checked on the card by ``test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import gemm as JG
from repro.core import packing as jpacking
from repro.models.model_zoo import PAPER_GEMM_SHAPES, PAPER_M
from repro_torch import gemm as TG
from repro_torch.configs.deepseek_7b import CONFIG as DS7B
from repro_torch.core import bitexact, packing as tpacking
from repro_torch.kernels import panel_gemm as K
from repro_torch.models import model_zoo as tzoo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many tiny products; with several test
    workers sharing the machine, torch's thread pool only adds contention
    (its idle threads spin while the workers' Python runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_plans():
    JG.plan_cache_clear()
    TG.plan_cache_clear()
    yield
    JG.plan_cache_clear()
    TG.plan_cache_clear()


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ packing
@pytest.mark.parametrize("k,n,bn,bk,transposed", [
    (256, 384, 128, 256, False),
    (300, 200, 512, 2048, False),        # ragged: padded to 128 multiples
    (4096 // 8, 11008 // 8, 512, 2048, False),
    (200, 300, 256, 128, True),          # [N, K] input
])
def test_pack_bit_identical_to_reference(k, n, bn, bk, transposed):
    rng = np.random.default_rng(0)
    w = _rand(rng, (n, k) if transposed else (k, n))
    tp = tpacking.pack(_t(w), transposed=transposed, block_n=bn,
                       block_k=bk)
    jp = jpacking.pack(jnp.asarray(w), transposed=transposed, block_n=bn,
                       block_k=bk)
    assert (tp.n, tp.k, tp.block_n, tp.block_k, tp.n_splits) == \
        (jp.n, jp.k, jp.block_n, jp.block_k, jp.n_splits)
    assert bitexact.bit_identical(tp.data, np.asarray(jp.data))


@pytest.mark.parametrize("widths", [(192, 64, 64), (688, 688), (300, 100)])
def test_pack_fused_bit_identical_to_reference(widths):
    rng = np.random.default_rng(1)
    parts = [_rand(rng, (256, w)) for w in widths]
    tp = tpacking.pack_fused([_t(p) for p in parts], block_n=512,
                             block_k=1024)
    jp = jpacking.pack_fused([jnp.asarray(p) for p in parts], block_n=512,
                             block_k=1024)
    assert (tp.n, tp.k, tp.block_n, tp.block_k, tp.n_splits) == \
        (jp.n, jp.k, jp.block_n, jp.block_k, jp.n_splits)
    assert bitexact.bit_identical(tp.data, np.asarray(jp.data))


def test_pack_percall_and_fit_block_equal_reference():
    rng = np.random.default_rng(2)
    w = _rand(rng, (130, 260))
    assert bitexact.bit_identical(
        tpacking.pack_percall(_t(w), transposed=True, block_n=128,
                              block_k=256),
        np.asarray(jpacking.pack_percall(jnp.asarray(w), transposed=True,
                                         block_n=128, block_k=256)))
    for dim in (64, 128, 200, 1600, 4096, 11008, 102400):
        for want in (128, 256, 512, 2048):
            assert tpacking.fit_block(dim, want) == \
                jpacking.fit_block(dim, want)


def test_pack_fused_rejects_mismatched_parts():
    with pytest.raises(ValueError):
        tpacking.pack_fused([torch.zeros((128, 128))])
    with pytest.raises(ValueError):
        tpacking.pack_fused([torch.zeros((128, 128)),
                             torch.zeros((256, 128))])


# -------------------------------------------------------------------- plans
_PLAN_FIELDS = ("m", "n", "k", "block_m", "block_n", "block_k", "pack",
                "lever", "split_k", "decode", "vmem_clamped", "occupancy",
                "t_pred", "fused_n_splits")


def _same_plan(tp, jp):
    for f in _PLAN_FIELDS:
        assert getattr(tp, f) == getattr(jp, f), (f, tp, jp)


@pytest.mark.parametrize("model,op,n,k", PAPER_GEMM_SHAPES)
def test_plans_on_paper_shapes_equal_reference(model, op, n, k):
    tp = TG.plan(PAPER_M, n, k)
    jp = JG.plan(PAPER_M, n, k, backend="interpret")
    _same_plan(tp, jp)
    # the lever contract of tests/test_gemm_api.py
    if k >= n:
        assert tp.lever == TG.LEVER_FINE_PANELS and not tp.prepack
    else:
        assert tp.lever == TG.LEVER_PREPACK and tp.prepack
        assert tp.block_k >= 512
    tdec = TG.plan(4, n, k, decode=True)
    jdec = JG.plan(4, n, k, decode=True, backend="interpret")
    _same_plan(tdec, jdec)


def _ds7b_packs(cfg):
    """(name, k, parts, pack epilogue, execute epilogue) of deepseek-7b."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    qkv = (cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim,
           cfg.num_kv_heads * cfg.head_dim)
    return [("wqkv", d, qkv, None, None),
            ("wo", cfg.num_heads * cfg.head_dim, (d,), None, None),
            ("w_gate_up", d, (f, f), "glu", "glu"),
            ("w_down", f, (d,), None, "residual"),
            ("lm_head", d, (v,), None, None)]


# The reference policy's resolution of deepseek-7b's packs: the blocks
# ``pack_blocks`` returns at m_hint = 128 and the decode split-K a plan at
# those blocks resolves; then the blocks the pack really has (pack_fused
# narrows block_n to fit each 11008-wide part: 256) and the decode split-K
# the model's own decode plans resolve at them.
DS7B_TABLE = {"wqkv": ((512, 2048), 1, (512, 2048), 1),
              "wo": ((512, 512), 1, (512, 512), 1),
              "w_gate_up": ((512, 1024), 2, (256, 1024), 4),
              "w_down": ((512, 256), 1, (512, 256), 1),
              "lm_head": ((512, 2048), 1, (512, 2048), 1)}


def _spec(mod, what, act):
    if what == "glu":
        return mod.EpilogueSpec(glu=act)
    if what == "residual":
        return mod.EpilogueSpec(residual=True)
    return None


@pytest.mark.parametrize("name", list(DS7B_TABLE))
def test_deepseek_7b_pack_blocks_and_decode_split_k(name):
    pk = {p[0]: p for p in _ds7b_packs(DS7B)}[name]
    _, k, parts, pack_what, exec_what = pk
    n_log = sum(parts)
    tb = TG.pack_blocks(n_log, k, m_hint=128,
                        epilogue=_spec(TG, pack_what, DS7B.act))
    jb = JG.pack_blocks(n_log, k, m_hint=128,
                        epilogue=_spec(JG, pack_what, DS7B.act))
    blocks, split, pack_blocks, model_split = DS7B_TABLE[name]
    assert tb == jb == blocks
    bn_pack = min(tpacking.fit_block(p, tb[0]) for p in parts)
    assert (bn_pack, tb[1]) == pack_blocks
    splits = parts if len(parts) > 1 else ()
    for bn, want in ((tb[0], split), (bn_pack, model_split)):
        n = sum(-(-p // bn) * bn for p in parts)
        for m in (1, 2, 4, 8):
            kw = dict(block_n=bn, block_k=tb[1], fused_n_splits=splits,
                      decode=True)
            tp = TG.plan(m, n, k, pack=TG.PACK_PREPACKED,
                         epilogue=_spec(TG, exec_what, DS7B.act), **kw)
            jp = JG.plan(m, n, k, pack=JG.PACK_PREPACKED,
                         backend="interpret",
                         epilogue=_spec(JG, exec_what, DS7B.act), **kw)
            _same_plan(tp, jp)
            assert tp.split_k == want, (bn, m)


def test_model_packs_equal_reference_layout():
    """``pack_for_inference`` on the reduced model: every pack's blocks,
    split map and bytes equal the reference's."""
    from repro.models import model_zoo as jzoo
    jcfg = jzoo.reduced_config(jzoo.get_config("deepseek-7b"))
    tcfg = tzoo.reduced_config(tzoo.get_config("deepseek-7b"))
    jparams = jzoo.build(jcfg, seed=0)
    tparams = tzoo.convert_params(_np_tree(jparams), device="cpu")
    jpk = jzoo.pack_for_inference(jcfg, jparams)
    tpk = tzoo.pack_for_inference(tcfg, tparams)
    for li, tl in enumerate(tpk["layers"]):
        for grp, key in (("attn", "wqkv"), ("attn", "wo"),
                         ("ffn", "w_gate_up"), ("ffn", "w_down")):
            tw, jw = tl[grp][key], jpk["layers"][grp][key]
            assert (tw.n, tw.k, tw.block_n, tw.block_k, tw.n_splits) == \
                (jw.n, jw.k, jw.block_n, jw.block_k, jw.n_splits)
            assert bitexact.bit_identical(tw.data,
                                          np.asarray(jw.data)[li]), key
    assert bitexact.bit_identical(tpk["lm_head"].data,
                                  np.asarray(jpk["lm_head"].data))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# ------------------------------------------------------------------ execute
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
M, KD, NH = 12, 512, 256           # rows, depth, output width


def _execute_pair(spec, split_k, rng, *, fused_parts=None):
    """Run one planned GEMM through both packages on the same inputs.
    Returns (port out, reference out, bound on |port - reference|)."""
    glu = spec is not None and "glu" in spec
    x = _rand(rng, (M, KD))
    if glu:
        parts = [_rand(rng, (KD, NH), KD ** -0.5) for _ in range(2)]
    elif fused_parts:
        parts = [_rand(rng, (KD, w), KD ** -0.5) for w in fused_parts]
    else:
        parts = [_rand(rng, (KD, NH), KD ** -0.5)]
    n_out = NH if glu else sum(p.shape[1] for p in parts)
    bias = res = None
    if spec and spec.get("bias"):
        bias = [_rand(rng, (p.shape[1],)) for p in parts]
    if spec and spec.get("residual"):
        res = _rand(rng, (M, n_out))
    outs = []
    for G, pk, arr in ((TG, tpacking, _t), (JG, jpacking, jnp.asarray)):
        if len(parts) > 1:
            pw = pk.pack_fused([arr(p) for p in parts], block_n=128,
                               block_k=128)
        else:
            pw = pk.pack(arr(parts[0]), block_n=128, block_k=128)
        es = G.EpilogueSpec(**spec) if spec else None
        kw = {} if G is TG else {"backend": "interpret"}
        p = G.plan(M, pw.n, pw.k, block_n=pw.block_n, block_k=pw.block_k,
                   pack=G.PACK_PREPACKED, epilogue=es,
                   fused_n_splits=pw.n_splits, split_k=split_k, **kw)
        assert p.split_k == split_k
        b = None
        if bias is not None:
            b = [arr(v) for v in bias] if len(parts) > 1 else arr(bias[0])
        y = G.execute(p, arr(x), pw, bias=b,
                      residual=None if res is None else arr(res))
        outs.append(np.asarray(y, np.float32) if G is JG else y.numpy())
    # the bound, on the packed operands the kernels see
    wcat = _t(np.concatenate(parts, axis=1))
    tspec = TG.EpilogueSpec(**spec) if spec else None
    bound = K.gemm_error_bound(
        _t(x), wcat,
        bias=None if bias is None else _t(np.concatenate(bias)),
        residual=None if res is None else _t(res), epilogue=tspec,
        out_dtype=torch.float32)
    return outs[0], outs[1], bound.numpy()


@pytest.mark.parametrize("split_k", [1, 2, 4])
@pytest.mark.parametrize("spec", EPILOGUES,
                         ids=lambda s: "none" if s is None else
                         "-".join(f"{k}={v}" for k, v in s.items()))
def test_execute_plain_matches_reference_interpret(spec, split_k):
    """|port - reference| <= 2*K*u*(|x| @ |w|) carried through the
    epilogue's slope, plus each side's transcendental roundings (see
    ``kernels.panel_gemm.gemm_error_bound``)."""
    rng = np.random.default_rng(10 + split_k)
    got, want, bound = _execute_pair(spec, split_k, rng)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("split_k", [1, 2, 4])
def test_execute_fused_split_matches_reference(split_k):
    """A fused (QKV-style) pack: one pass, parts sliced by the static split
    map, each within the bound of the reference's part."""
    rng = np.random.default_rng(20 + split_k)
    widths = (256, 128, 128)
    got, want, bound = _execute_pair(None, split_k, rng,
                                     fused_parts=widths)
    assert np.all(np.abs(got - want) <= bound)
    pw = tpacking.pack_fused([torch.zeros((KD, w)) for w in widths],
                             block_n=128, block_k=128)
    p = TG.plan_for_packed(M, pw)
    parts = TG.split_fused(p, torch.from_numpy(got))
    assert [t.shape[-1] for t in parts] == list(widths)
    off = 0
    for part, w in zip(parts, widths):
        assert np.array_equal(part.numpy(), got[:, off:off + w])
        off += w


def test_execute_raw_weight_packs_per_call():
    """A raw [N, K] weight under a transposed plan is packed inside the
    call; the result equals the prepacked path bit for bit."""
    rng = np.random.default_rng(30)
    x, w = _t(_rand(rng, (7, 300))), _t(_rand(rng, (300, 200)))
    p_raw = TG.plan(7, 200, 300, transposed=True, pack=TG.PACK_PERCALL)
    y_raw = TG.execute(p_raw, x, w.T.contiguous())
    pw = TG.pack_for_plan(p_raw, w, transposed=False)
    p_pk = TG.plan_for_packed(7, pw)
    assert bitexact.bit_identical(y_raw, TG.execute(p_pk, x, pw))
    with pytest.raises(TG.PlanMismatchError):
        TG.execute(p_pk, x[:6], pw)


def test_validate_plan_gate_on_plain_emulator():
    for spec in (None, TG.EpilogueSpec(bias=True, act="gelu"),
                 TG.EpilogueSpec(glu="silu", residual=True)):
        for s in (1, 2):
            p = TG.plan(8, 256, 512, block_n=128, block_k=128,
                        epilogue=spec, split_k=s, validate=True)
            assert p.validated and TG.validate_plan(p)


def test_plan_cache_counts_hits_and_misses():
    p = TG.plan(128, 2048, 2048)
    assert TG.plan(128, 2048, 2048) is p
    info = TG.plan_cache_info()
    assert (info.hits, info.misses, info.currsize) == (1, 1, 1)
    with TG.decode_lane():
        assert TG.plan(4, 2048, 2048).decode
    assert TG.bucket_m(3) == 8 and TG.bucket_m(3, decode=True) == 4
    assert TG.bucket_m(200) == 256


# ----------------------------------------------------- backends, no fallback
def test_backends_route_by_device_and_never_fall_back():
    assert TG.default_backend("cpu") == "plain"
    assert TG.default_backend(torch.device("cuda")) == "cuda"
    assert set(TG.list_backends()) >= {"cuda", "plain", "torch"}
    x, w = torch.ones((8, 128)), torch.ones((128, 128))
    for name in ("cuda", "torch"):
        with pytest.raises(ValueError):
            TG.get_backend(name).run(x, w, block_m=8, block_n=128,
                                     block_k=128, out_dtype=torch.float32)
    with pytest.raises(TG.UnknownBackendError):
        TG.plan(8, 128, 128, backend="xla")


def test_wrappers_on_cpu_run_the_plain_version_without_counting():
    rng = np.random.default_rng(31)
    x, w = _t(_rand(rng, (16, 256))), _t(_rand(rng, (256, 256)))
    n0, s0 = K.panel_gemm.launches, K.panel_gemm_splitk.launches
    y = K.panel_gemm(x, w, block_m=16, block_n=128, block_k=128)
    assert bitexact.bit_identical(
        y, K.panel_gemm_plain(x, w, block_k=128))
    y2 = K.panel_gemm_splitk(x[:8], w, split_k=2, block_m=8, block_n=128,
                             block_k=128)
    assert bitexact.bit_identical(
        y2, K.panel_gemm_splitk_plain(x[:8], w, split_k=2, block_k=128))
    assert (K.panel_gemm.launches, K.panel_gemm_splitk.launches) == (n0, s0)
    with pytest.raises(ValueError):          # unpadded: pack first
        K.panel_gemm(x[:, :200], w[:200], block_m=16, block_n=128,
                     block_k=128)
    with pytest.raises(ValueError):          # operand without its flag
        K.panel_gemm(x, w, torch.zeros(256), block_m=16, block_n=128,
                     block_k=128)


# ------------------------------------------- the plain version's own laws
def test_plain_version_is_deterministic_and_batch_invariant():
    """Every row is its own fixed-shape product per K block, so a row's
    result depends on that row and the weight only."""
    rng = np.random.default_rng(40)
    x = _t(_rand(rng, (128, 512)))
    w = _t(_rand(rng, (512, 384), 512 ** -0.5))
    spec = K.EpilogueSpec(act="silu")
    full = K.panel_gemm_plain(x, w, block_k=256, epilogue=spec)
    assert bitexact.bit_identical(
        full, K.panel_gemm_plain(x, w, block_k=256, epilogue=spec))
    for m in (1, 2, 5, 8, 16, 77):
        assert bitexact.bit_identical(
            K.panel_gemm_plain(x[:m], w, block_k=256, epilogue=spec),
            full[:m]), m
    perm = torch.from_numpy(rng.permutation(128))
    assert bitexact.bit_identical(
        K.panel_gemm_plain(x[perm], w, block_k=256, epilogue=spec),
        full[perm])
    sk = K.panel_gemm_splitk_plain(x, w, split_k=2, block_k=128)
    assert bitexact.bit_identical(
        K.panel_gemm_splitk_plain(x[3:4], w, split_k=2, block_k=128),
        sk[3:4])


def test_execute_plain_rows_do_not_depend_on_m():
    """Through plan/execute (row padding to the plan's block_m included):
    a row's output is the same at M = 1, 8 and 128."""
    rng = np.random.default_rng(41)
    x = _t(_rand(rng, (128, 384)))
    pw = tpacking.pack(_t(_rand(rng, (384, 640), 0.05)), block_n=128,
                       block_k=128)
    outs = {}
    for m in (1, 8, 128):
        p = TG.plan_for_packed(m, pw, epilogue=TG.EpilogueSpec(act="gelu"))
        outs[m] = TG.execute(p, x[:m], pw)
    assert bitexact.bit_identical(outs[1], outs[128][:1])
    assert bitexact.bit_identical(outs[8], outs[128][:8])


def test_error_bound_is_the_summation_bound_without_epilogue():
    rng = np.random.default_rng(42)
    x, w = _t(_rand(rng, (8, 256))), _t(_rand(rng, (256, 128)))
    b = K.gemm_error_bound(x, w, out_dtype=torch.float32)
    core = 2 * 256 * 2.0 ** -24 * (x.abs() @ w.abs())
    assert torch.all(b >= core) and torch.all(b <= 1.01 * core + 1e-5)
    assert torch.all(K.gemm_error_bound(x, w, out_dtype=torch.bfloat16)
                     > b)
