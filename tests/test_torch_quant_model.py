"""Quantized serving of the PyTorch port against the JAX reference, on
reduced deepseek-7b on the CPU.

The reference engine quantizes the model (``Engine(quant=...)``); its
packs are carried across as numpy (``model_zoo.convert_params``) so both
packages run the same codes and scales.

Measured bounds (max |port - reference| over the logits, relative to the
reference's max |logit|; reduced deepseek-7b, seed 0, a 9-token prompt,
batch 2, prefill and two decode steps, fp32 compute, on the CPU): at most
4.24e-7 for int8 and 3.72e-7 for ternary, fused and unfused.  The
dequantized weights are the same bit for bit, so only the fp32 GEMM sums'
orders differ; the gate is the fp32 gate of ``test_torch_model.py``, 5e-6.
Greedy tokens are equal.

The reference's ``serve`` is never called here (it races XLA:CPU's
asynchronous dispatch; ROADMAP queue 3); the port's ``serve`` is held to
its own ``generate`` in ``test_torch_quant_serving.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model_zoo as JZ
from repro.runtime.serve_loop import Engine as JEngine
from repro_torch.core import bitexact
from repro_torch.core.packing import PackedWeight
from repro_torch.models import model_zoo as TZ
from repro_torch.quant import formats as TF
from repro_torch.quant import ledger as TL
from repro_torch.runtime.serve_loop import Engine as TEngine

FORMATS = ("int8", "ternary")
FP32_REL = 5e-6
MAX_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many tiny products; with several test
    workers sharing the machine, torch's thread pool only adds contention."""
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
    jcfg, _ = _cfgs("float32")
    return JZ.build(jcfg, seed=0)


_ENGINES = {}


@pytest.fixture(scope="module")
def engines(jparams):
    """(port engine on the carried packs, reference engine) per (format,
    fuse), fp32 compute, built once per module."""
    def get(fmt, fuse):
        key = (fmt, fuse)
        if key not in _ENGINES:
            jcfg, tcfg = _cfgs("float32")
            jeng = JEngine(jcfg, jparams, max_len=MAX_LEN, packed=True,
                           backend="xla", fuse=fuse, quant=fmt)
            carried = TZ.convert_params(jax.tree.map(np.asarray, jeng.params),
                                        device="cpu")
            teng = TEngine(tcfg, carried, max_len=MAX_LEN, device="cpu",
                           fuse=fuse, quant=fmt)
            _ENGINES[key] = (teng, jeng)
        return _ENGINES[key]
    yield get
    _ENGINES.clear()


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / \
        np.abs(want).max()


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("fmt,fuse", [("int8", True), ("ternary", True),
                                      ("int8", False)],
                         ids=["int8-fused", "ternary-fused", "int8-unfused"])
def test_quant_logits_match_reference_on_carried_packs(fmt, fuse, engines):
    teng, jeng = engines(fmt, fuse)
    rng = np.random.default_rng(7)
    prompts = rng.integers(1, 128, (2, 9)).astype(np.int32)
    lt, ct = teng.prefill(prompts)
    lj, cj = jeng.prefill(jnp.asarray(prompts))
    assert lt.shape == lj.shape
    assert _rel(lt.numpy(), lj) <= FP32_REL
    tok = np.asarray(lj).argmax(-1)[:, None].astype(np.int32)
    for _ in range(2):
        dt, ct = teng.decode(ct, torch.from_numpy(tok))
        dj, cj = jeng.decode(cj, jnp.asarray(tok))
        assert _rel(dt.numpy(), dj) <= FP32_REL
        tok = np.asarray(dj).argmax(-1)[:, None].astype(np.int32)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_generate_tokens_equal_reference(fmt, engines):
    teng, jeng = engines(fmt, True)
    prompts = np.random.default_rng(8).integers(1, 128, (1, 11)).astype(
        np.int32)
    got, stats = teng.generate(prompts, 6)
    want = np.asarray(jeng.generate(jnp.asarray(prompts), 6)[0])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (stats.quant, stats.quant_density, stats.quant_sparse_packs) == \
        (fmt, 1.0, 0)


@pytest.mark.parametrize("fmt", FORMATS)
def test_convert_params_carries_quantized_packs(fmt, engines):
    teng, jeng = engines(fmt, True)
    jl, tl = jeng.params["layers"], teng.params["layers"]
    for li, layer in enumerate(tl):
        for grp, key in (("attn", "wqkv"), ("attn", "wo"),
                         ("ffn", "w_gate_up"), ("ffn", "w_down")):
            tw, jw = layer[grp][key], jl[grp][key]
            assert isinstance(tw, TF.QuantizedPackedWeight)
            assert (tw.n, tw.k, tw.block_n, tw.block_k, tw.n_splits,
                    tw.fmt) == (jw.n, jw.k, jw.block_n, jw.block_k,
                                jw.n_splits, jw.fmt)
            assert bitexact.bit_identical(tw.data, np.asarray(jw.data)[li])
            assert bitexact.bit_identical(tw.scales,
                                          np.asarray(jw.scales)[li])
    head = teng.params["lm_head"]
    assert type(head) is PackedWeight
    assert bitexact.bit_identical(head.data,
                                  np.asarray(jeng.params["lm_head"].data))


@pytest.mark.parametrize("fmt", FORMATS)
def test_own_quantized_packs_equal_reference(fmt, jparams, engines):
    """The port's own ``pack_for_inference(quant=)`` on the raw weights:
    every pack's layout equals the reference's; int8 codes and scales bit
    for bit, ternary scales within 8 ulps (``test_torch_quant.py``)."""
    _, tcfg = _cfgs("float32")
    _, jeng = engines(fmt, True)
    raw = TZ.convert_params(jax.tree.map(np.asarray, jparams), device="cpu")
    own = TZ.pack_for_inference(tcfg, raw, quant=fmt)
    jl = jeng.params["layers"]
    for li, layer in enumerate(own["layers"]):
        for grp, key in (("attn", "wqkv"), ("ffn", "w_gate_up"),
                         ("ffn", "w_down")):
            tw, jw = layer[grp][key], jl[grp][key]
            assert (tw.n, tw.k, tw.block_n, tw.block_k, tw.n_splits) == \
                (jw.n, jw.k, jw.block_n, jw.block_k, jw.n_splits)
            js = np.asarray(jw.scales)[li]
            if fmt == "int8":
                assert bitexact.bit_identical(tw.data,
                                              np.asarray(jw.data)[li])
                assert bitexact.bit_identical(tw.scales, js)
            else:
                ulps = np.abs(tw.scales.numpy().view(np.int32).astype(
                    np.int64) - js.view(np.int32).astype(np.int64))
                assert ulps.max() <= 8
            assert TL.lookup(tw.n, tw.k, fmt).within_tol
