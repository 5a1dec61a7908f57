"""Quantized serving inside the PyTorch port, on reduced deepseek-7b on the
CPU: ``serve`` equals ``generate`` token for token for both formats, fused
and unfused, on the ``plain`` backend; the ``keep_fp32`` roles; the
quantized engine consuming its raw weights.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import bitexact
from repro_torch.core.packing import PackedWeight
from repro_torch.models import model_zoo as TZ
from repro_torch.quant import formats as TF
from repro_torch.runtime.serve_loop import Engine as TEngine

FORMATS = ("int8", "ternary")
MAX_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many tiny products; with several test
    workers sharing the machine, torch's thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(dtype):
    cfg = TZ.reduced_config(TZ.get_config("deepseek-7b"))
    if dtype is None:
        return cfg
    return dataclasses.replace(cfg, compute_dtype=dtype, cache_dtype=dtype)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_serve_equals_generate(fmt, fuse):
    """Continuous batching on quantized packs returns per-request greedy
    ``generate`` token for token (bf16 compute, as configured)."""
    tcfg = _cfg(None)
    eng = TEngine(tcfg, TZ.build(tcfg, seed=0, device="cpu"),
                  max_len=MAX_LEN, device="cpu", fuse=fuse, quant=fmt)
    reqs = [np.random.default_rng(i).integers(1, 128, n)
            for i, n in enumerate((5, 17, 9))]
    outs, stats = eng.serve(reqs, batch_slots=2, max_new_tokens=4,
                            prefill_chunk=8, page_size=8,
                            check_invariants=True)
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o, eng.generate(r[None], 4)[0][0]
                                      .numpy())
    assert (stats.quant, stats.quant_density, stats.fused) == \
        (fmt, 1.0, fuse)


def test_keep_fp32_roles_and_fused_groups():
    """The head (and embeddings) stay fp32 by default; a fused group with
    a kept member stays fp32 whole; an unknown format raises."""
    tcfg = _cfg("float32")
    raw = TZ.build(tcfg, seed=1, device="cpu")
    eng = TEngine(tcfg, raw, max_len=MAX_LEN, device="cpu", quant="int8",
                  keep_fp32=("head", "embed", "wk"))
    attn = eng.params["layers"][0]["attn"]
    assert type(attn["wqkv"]) is PackedWeight
    assert isinstance(attn["wo"], TF.QuantizedPackedWeight)
    assert isinstance(eng.params["layers"][0]["ffn"]["w_gate_up"],
                      TF.QuantizedPackedWeight)
    assert type(eng.params["lm_head"]) is PackedWeight
    assert isinstance(eng.params["embed"], torch.Tensor)
    assert eng.generate(np.arange(1, 6)[None], 3)[1].quant == "int8"
    fp = TEngine(tcfg, TZ.build(tcfg, seed=1, device="cpu"),
                 max_len=MAX_LEN, device="cpu")
    assert fp.generate(np.arange(1, 6)[None], 2)[1].quant_density is None
    with pytest.raises(TF.QuantFormatError):
        TEngine(tcfg, TZ.build(tcfg, seed=1, device="cpu"), max_len=MAX_LEN,
                device="cpu", quant="int4")


def test_quant_consume_releases_raw_weights():
    """``consume=True`` empties the raw tree as each quantized pack is
    made, and the engine computes what an engine on a kept copy does."""
    tcfg = _cfg("float32")
    raw = TZ.build(tcfg, seed=5, device="cpu")
    keep = TZ.build(tcfg, seed=5, device="cpu")
    a = TEngine(tcfg, raw, max_len=MAX_LEN, device="cpu", consume=True,
                quant="ternary")
    b = TEngine(tcfg, keep, max_len=MAX_LEN, device="cpu", quant="ternary")
    assert "wq" not in raw["layers"][0]["attn"] and "lm_head" not in raw
    prompts = np.arange(1, 12)[None]
    assert bitexact.bit_identical(a.prefill(prompts)[0],
                                  b.prefill(prompts)[0])
