"""The port's model against the JAX reference on reduced deepseek-7b.

The reference's parameters are built once with JAX, carried across as
numpy (``model_zoo.convert_params``) and run through both packages.

Measured bounds (max |port - reference| over the logits, relative to the
reference's max |logit|; reduced deepseek-7b, seeds 0 and 1, prompt
lengths 1-40, batch 2, on the CPU):

* float32 compute and cache: at most 5.7e-7 at prefill and 5.6e-7 at
  decode.  Both packages sum every fp32 product in their own orders, so
  the difference is a few fp32 ulps of the logits; the gate is 5e-6.
* bfloat16 compute (deepseek-7b as configured): at most 1.2e-2 at prefill
  and 7.7e-3 at decode.  The two frameworks round activations to bf16
  (8 significant bits, 3.9e-3 relative) at their own places, and one
  bf16 ulp of a logit of ~3 is 1.6e-2 absolute; the gate is 2**-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import model_zoo as JZ
from repro.runtime.serve_loop import Engine as JEngine
from repro_torch.configs import base as tbase
from repro_torch.core import bitexact
from repro_torch.models import model_zoo as TZ
from repro_torch.runtime.serve_loop import Engine as TEngine

FP32_REL = 5e-6
BF16_REL = 2.0 ** -5
MAX_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many tiny products; with several test
    workers sharing the machine, torch's thread pool only adds contention
    (its idle threads spin while the workers' Python runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype):
    kw = {} if dtype is None else dict(compute_dtype=dtype,
                                       cache_dtype=dtype)
    j = dataclasses.replace(JZ.reduced_config(JZ.get_config("deepseek-7b")),
                            **kw)
    t = dataclasses.replace(TZ.reduced_config(TZ.get_config("deepseek-7b")),
                            **kw)
    return j, t


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs(None)
    return JZ.build(jcfg, seed=0)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


# ------------------------------------------------------------------ configs
def test_deepseek_7b_config_equals_reference():
    t, j = TZ.get_config("deepseek-7b"), JZ.get_config("deepseek-7b")
    shared = [f.name for f in dataclasses.fields(tbase.ModelConfig)]
    for name in shared:
        assert getattr(t, name) == getattr(j, name), name
    assert t.param_count() == j.param_count()
    assert t.cdtype == torch.bfloat16 and t.pdtype == torch.float32
    assert t.kvdtype == torch.bfloat16


def test_reduced_config_equals_reference():
    j, t = _cfgs(None)
    for f in dataclasses.fields(tbase.ModelConfig):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.num_layers, t.d_model) == (2, 64)
    assert {f.name for f in dataclasses.fields(tbase.ModelConfig)} <= \
        {f.name for f in dataclasses.fields(jbase.ModelConfig)}


def test_unported_archs_raise():
    with pytest.raises(KeyError):
        TZ.get_config("gemma2-9b")
    cfg = dataclasses.replace(TZ.reduced_config(TZ.get_config(
        "deepseek-7b")), attention_kind="mla")
    with pytest.raises(NotImplementedError):
        TZ.build(cfg, seed=0, device="cpu")


# --------------------------------------------------------------- parameters
def test_convert_params_round_trips_the_whole_tree(jparams):
    tree = _np_tree(jparams)
    port = TZ.convert_params(tree, device="cpu")
    assert set(port) == set(tree)
    n_layers = JZ.reduced_config(JZ.get_config("deepseek-7b")).num_layers
    assert isinstance(port["layers"], list) and \
        len(port["layers"]) == n_layers
    leaves = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [p.key for p in path]
        node = port
        if keys[0] == "layers":
            for li in range(n_layers):
                node = port["layers"][li]
                for kk in keys[1:]:
                    node = node[kk]
                assert bitexact.bit_identical(node, leaf[li]), keys
                leaves += 1
            continue
        for kk in keys:
            node = node[kk]
        assert bitexact.bit_identical(node, leaf), keys
        assert node.device.type == "cpu"
        leaves += 1
    assert leaves > 10


def test_build_is_seeded_and_placed():
    _, cfg = _cfgs(None)
    a = TZ.build(cfg, seed=3, device="cpu")
    b = TZ.build(cfg, seed=3, device="cpu")
    c = TZ.build(cfg, seed=4, device="cpu")
    assert bitexact.bit_identical(a["lm_head"], b["lm_head"])
    assert not bitexact.bit_identical(a["lm_head"], c["lm_head"])
    w = a["layers"][1]["ffn"]["w_down"]
    assert tuple(w.shape) == (cfg.d_ff, cfg.d_model)
    assert w.dtype == torch.float32 and w.device.type == "cpu"


def test_entry_points_refuse_to_run_on_the_cpu_unasked():
    """Without a card, asking for nothing (= CUDA) raises: the port never
    falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device exists")
    _, cfg = _cfgs(None)
    with pytest.raises(RuntimeError):
        TZ.build(cfg, seed=0)
    params = TZ.build(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError):
        TEngine(cfg, params, max_len=MAX_LEN)


# ------------------------------------------------------------------- logits
def _engines(dtype, jparams, *, fuse=True):
    jcfg, tcfg = _cfgs(dtype)
    teng = TEngine(tcfg, TZ.convert_params(_np_tree(jparams), device="cpu"),
                   max_len=MAX_LEN, device="cpu", fuse=fuse)
    jeng = JEngine(jcfg, jparams, max_len=MAX_LEN, packed=True,
                   backend="xla", fuse=fuse)
    return teng, jeng


@pytest.mark.parametrize("dtype,rel", [("float32", FP32_REL),
                                       (None, BF16_REL)],
                         ids=["float32", "bfloat16-as-configured"])
def test_logits_prefill_and_decode_match_reference(dtype, rel, jparams):
    teng, jeng = _engines(dtype, jparams)
    rng = np.random.default_rng(7)
    for length in (1, 9, 23):
        prompts = rng.integers(1, 128, (2, length)).astype(np.int32)
        lt, ct = teng.prefill(prompts)
        lj, cj = jeng.prefill(jnp.asarray(prompts))
        lj = np.asarray(lj, np.float32)
        assert lt.shape == lj.shape
        assert np.abs(lt.float().numpy() - lj).max() <= \
            rel * np.abs(lj).max(), length
        tok = lj.argmax(-1)[:, None].astype(np.int32)
        for _ in range(2):
            dt, ct = teng.decode(ct, torch.from_numpy(tok))
            dj, cj = jeng.decode(cj, jnp.asarray(tok))
            dj = np.asarray(dj, np.float32)
            assert np.abs(dt.float().numpy() - dj).max() <= \
                rel * np.abs(dj).max(), length
            tok = dj.argmax(-1)[:, None].astype(np.int32)


def test_fused_equals_unfused_in_fp32(jparams):
    """Inside the port, the fused packs (one QKV pass; gate+up with the glu
    combine and the residual in the store step) equal the unfused layers
    bit for bit in fp32 compute, as in the reference.  (In bf16 compute
    neither package has this law: the unfused path rounds the gate and up
    outputs to bf16 before the product.)"""
    jcfg, tcfg = _cfgs("float32")
    tree = _np_tree(jparams)
    fused = TEngine(tcfg, TZ.convert_params(tree, device="cpu"),
                    max_len=MAX_LEN, device="cpu")
    unfused = TEngine(tcfg, TZ.convert_params(tree, device="cpu"),
                      max_len=MAX_LEN, device="cpu", fuse=False)
    assert "wqkv" in fused.params["layers"][0]["attn"]
    assert "wq" in unfused.params["layers"][0]["attn"]
    prompts = np.random.default_rng(8).integers(1, 128, (2, 13))
    lf, cf = fused.prefill(prompts)
    lu, cu = unfused.prefill(prompts)
    assert bitexact.bit_identical(lf, lu)
    tok = torch.argmax(lf, -1)[:, None]
    df, _ = fused.decode(cf, tok)
    du, _ = unfused.decode(cu, tok)
    assert bitexact.bit_identical(df, du)


def test_pack_consume_releases_raw_weights():
    """``consume=True`` (used at full size) empties the raw tree as each
    pack is made, and the packed model computes the same logits."""
    _, cfg = _cfgs("float32")
    raw = TZ.build(cfg, seed=5, device="cpu")
    keep = TZ.build(cfg, seed=5, device="cpu")
    a = TEngine(cfg, raw, max_len=MAX_LEN, device="cpu", consume=True)
    b = TEngine(cfg, keep, max_len=MAX_LEN, device="cpu")
    assert "lm_head" not in raw and "wq" not in raw["layers"][0]["attn"]
    assert "lm_head" in keep
    prompts = np.arange(1, 12)[None]
    assert bitexact.bit_identical(a.prefill(prompts)[0],
                                  b.prefill(prompts)[0])


def test_dense_features_beyond_deepseek_match_reference():
    """The forward's other dense-family features (logit and attention
    softcaps, post-norms, sqrt(d) embedding scale, tied embeddings,
    (1 + scale) norms, gelu, alternating sliding windows) against the
    reference, on reduced gemma2-9b carried onto the port's config, fp32
    compute: logits within the fp32 gate, greedy tokens equal."""
    jcfg = dataclasses.replace(JZ.reduced_config(JZ.get_config("gemma2-9b")),
                               compute_dtype="float32", cache_dtype="float32")
    tcfg = tbase.ModelConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(tbase.ModelConfig)})
    assert tcfg.post_norms and tcfg.tie_embeddings and tcfg.logit_softcap
    jp = JZ.build(jcfg, seed=0)
    teng = TEngine(tcfg, TZ.convert_params(_np_tree(jp), device="cpu"),
                   max_len=MAX_LEN, device="cpu")
    jeng = JEngine(jcfg, jp, max_len=MAX_LEN, packed=True, backend="xla")
    prompts = np.random.default_rng(9).integers(1, 128, (2, 40)).astype(
        np.int32)                        # longer than the window of 32
    lt, _ = teng.prefill(prompts)
    lj = np.asarray(jeng.prefill(jnp.asarray(prompts))[0], np.float32)
    assert np.abs(lt.numpy() - lj).max() <= FP32_REL * np.abs(lj).max()
    np.testing.assert_array_equal(
        teng.generate(prompts[:1], 6)[0].numpy(),
        np.asarray(jeng.generate(jnp.asarray(prompts[:1]), 6)[0]))
