"""Serving in the PyTorch port: the paged KV cache against the JAX
reference, the page allocator's laws, port ``generate`` against JAX
``generate`` on the same weights, and port ``serve`` == port ``generate``
token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model_zoo as JZ
from repro.runtime import kv_cache as JKV
from repro.runtime.serve_loop import Engine as JEngine
from repro_torch.models import model_zoo as TZ
from repro_torch.runtime import kv_cache as TKV
from repro_torch.runtime.batching import ContinuousBatchingScheduler
from repro_torch.runtime.serve_loop import Engine as TEngine

MAX_LEN = 64
# bf16 logit bound of tests/test_torch_model.py (relative to max |logit|)
BF16_REL = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many tiny products; with several test
    workers sharing the machine, torch's thread pool only adds contention
    (its idle threads spin while the workers' Python runs)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ paged ops
def _trace(rng, *, slots=3, n_view=4, page_size=4, phys=14, s=5):
    """A random page table (distinct physical pages, some unmapped),
    lengths near and past the table end, and a write mask."""
    ids = rng.permutation(phys)[:slots * n_view].reshape(slots, n_view)
    table = np.where(rng.random((slots, n_view)) < 0.2, -1, ids)
    lens = rng.integers(0, n_view * page_size, (slots,))
    mask = rng.random((slots,)) < 0.7
    pages = rng.standard_normal((phys, page_size, 2, 3)).astype(np.float32)
    new = rng.standard_normal((slots, s, 2, 3)).astype(np.float32)
    return (pages, new, table.astype(np.int32), lens.astype(np.int32),
            mask, page_size)


@pytest.mark.parametrize("seed", range(6))
def test_paged_update_and_gather_match_reference(seed):
    """Writes through unmapped entries, past the table end and for masked
    rows are dropped, as the reference's ``mode="drop"`` scatter drops
    them."""
    pages, new, table, lens, mask, ps = _trace(np.random.default_rng(seed))
    for wm in (None, mask):
        tp = TKV.paged_update(
            torch.from_numpy(pages.copy()), torch.from_numpy(new),
            torch.from_numpy(table), torch.from_numpy(lens), ps,
            write_mask=None if wm is None else torch.from_numpy(wm))
        jp = JKV.paged_update(jnp.asarray(pages), jnp.asarray(new),
                              jnp.asarray(table), jnp.asarray(lens), ps,
                              write_mask=None if wm is None
                              else jnp.asarray(wm))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(
            TKV.paged_gather(tp, torch.from_numpy(table), ps).numpy(),
            np.asarray(JKV.paged_gather(jp, jnp.asarray(table), ps)))


def test_paged_update_drops_every_invalid_write():
    pages = torch.zeros((4, 2, 1))
    table = torch.tensor([[0, -1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([1, 3], dtype=torch.int32)
    new = torch.ones((2, 3, 1))
    out = TKV.paged_update(pages, new, table, lens, 2,
                           write_mask=torch.tensor([True, True]))
    # slot 0: position 1 -> page 0 row 1; positions 2, 3 are unmapped
    # slot 1: position 3 -> page 3 row 1; positions 4, 5 are past the end
    assert out.flatten().tolist() == [0, 1, 0, 0, 0, 0, 0, 1]
    assert out.data_ptr() == pages.data_ptr()           # in place


# -------------------------------------------------------------- allocator
def _pool(num_pages=None, **kw):
    cfg = TZ.reduced_config(TZ.get_config("deepseek-7b"))
    return TKV.PagedKVCache(num_layers=cfg.num_layers, num_slots=3,
                            max_len=32, page_size=8,
                            leaf_specs=TKV.leaf_specs_for(cfg),
                            num_pages=num_pages, device="cpu", **kw)


def test_allocator_alloc_free_refcount_laws():
    kv = _pool()
    assert kv.num_pages == 12 and kv.free_count == 12
    assert [TKV.pages_for(t, 8) for t in (0, 1, 8, 9)] == \
        [JKV.pages_for(t, 8) for t in (0, 1, 8, 9)] == [0, 1, 1, 2]
    kv.alloc(0, 9)
    kv.alloc(1, 1)
    kv.alloc(0, 16)                   # already covered: no new page
    assert (kv.held(0), kv.held(1), kv.free_count) == (2, 1, 9)
    assert set(kv.refcount.tolist()) == {0, 1}
    kv.check_no_aliasing()
    held0 = kv.page_table[0, :2].tolist()
    assert sorted(kv.free(0)) == sorted(held0)
    assert kv.held(0) == 0 and kv.free_count == 11
    with pytest.raises(ValueError):   # past max_len
        kv.alloc(2, 33)
    kv.free(1)
    kv.assert_all_free()
    assert tuple(kv.pages["pages_k"].shape) == (2, 12, 8, 2, 16)


def test_allocator_out_of_pages_and_audits():
    kv = _pool(num_pages=3)
    kv.alloc(0, 16)
    with pytest.raises(TKV.OutOfPagesError):
        kv.alloc(1, 16)
    with pytest.raises(TKV.PageLeakError):
        kv.assert_all_free()
    kv.refcount[kv.page_table[0, 0]] = 2          # corrupt a refcount
    with pytest.raises(TKV.PageAliasError):
        kv.check_no_aliasing()
    kv.refcount[kv.page_table[0, 0]] = 1
    p = int(kv.page_table[0, 0])
    kv._free.append(p)                            # live and free at once
    with pytest.raises(TKV.PageAliasError):
        kv.check_no_aliasing()
    with pytest.raises(ValueError):
        TKV.PagedKVCache(num_layers=1, num_slots=1, max_len=30,
                         page_size=8, leaf_specs={})


# ------------------------------------------------------------- engines
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
    return JZ.build(_cfgs(None)[0], seed=0)


def _port(cfg, jparams):
    return TEngine(cfg, TZ.convert_params(jax.tree.map(np.asarray, jparams),
                                          device="cpu"),
                   max_len=MAX_LEN, device="cpu")


PROMPT_LENS = (9, 5, 17, 23)


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, (1, n)).astype(np.int32)
            for n in PROMPT_LENS]


def test_generate_equals_reference_in_fp32(jparams):
    jcfg, tcfg = _cfgs("float32")
    teng = _port(tcfg, jparams)
    jeng = JEngine(jcfg, jparams, max_len=MAX_LEN, packed=True,
                   backend="xla")
    for p in _prompts():
        toks, st = teng.generate(p, 8)
        jt, _ = jeng.generate(jnp.asarray(p), 8)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
        assert (st.prefill_tokens, st.decode_tokens) == (p.shape[1], 8)


def test_generate_bf16_equal_or_divergence_explained(jparams):
    """As configured (bf16 compute) the tokens equal the reference's, or
    they part where the reference's own top two logits lie within the bf16
    bound of each other: at that step the port's token is one the
    reference scores within the bound of its best."""
    jcfg, tcfg = _cfgs(None)
    teng = _port(tcfg, jparams)
    jeng = JEngine(jcfg, jparams, max_len=MAX_LEN, packed=True,
                   backend="xla")
    n_equal = 0
    for p in _prompts():
        toks = teng.generate(p, 8)[0].numpy()[0]
        jt = np.asarray(jeng.generate(jnp.asarray(p), 8)[0])[0]
        if np.array_equal(toks, jt):
            n_equal += 1
            continue
        i = int(np.flatnonzero(toks != jt)[0])
        ctx = np.concatenate([p[0], jt[:i]])[None].astype(np.int32)
        lj = np.asarray(jeng.prefill(jnp.asarray(ctx))[0], np.float32)[0]
        assert lj.max() - lj[toks[i]] <= BF16_REL * np.abs(lj).max(), \
            (p.shape, i, toks, jt)
    assert n_equal >= 2


@pytest.mark.parametrize("dtype", ["float32", None],
                         ids=["float32", "bfloat16-as-configured"])
@pytest.mark.parametrize("slots", [1, 2])
def test_serve_equals_generate(dtype, slots, jparams):
    """Continuous batching (slot refill, chunked prefill, paged decode at
    M = slots) returns per-request greedy ``generate``'s tokens exactly."""
    _, tcfg = _cfgs(dtype)
    eng = _port(tcfg, jparams)
    reqs = [p[0] for p in _prompts(1)] + [np.arange(3, 43) % 120 + 1]
    max_new = [6, 3, 8, 4, 5]
    outs, stats = eng.serve(reqs, batch_slots=slots, max_new_tokens=max_new,
                            prefill_chunk=8, page_size=8,
                            check_invariants=True)
    for r, m, o in zip(reqs, max_new, outs):
        want = eng.generate(r[None], m)[0].numpy()[0]
        np.testing.assert_array_equal(o, want)
    assert stats.prefill_tokens == sum(len(r) for r in reqs)
    assert stats.decode_tokens == sum(max_new)
    assert len(stats.requests) == len(reqs)
    if slots == 2:      # two requests really shared decode steps
        assert stats.decode_ticks < sum(m - 1 for m in max_new)


def test_serve_under_page_pressure_admits_fifo(jparams):
    """With pages for one request at a time, admission waits for the head
    of the queue and the outputs still equal ``generate``."""
    _, tcfg = _cfgs("float32")
    eng = _port(tcfg, jparams)
    reqs = [p[0] for p in _prompts(2)]
    sched = ContinuousBatchingScheduler(eng, batch_slots=2, prefill_chunk=8,
                                        page_size=8, num_pages=4,
                                        check_invariants=True)
    outs, _ = sched.run(reqs, 4)
    admits = [e[1] for e in sched.trace if e[0] == "admit"]
    assert admits == sorted(admits)
    for r, o in zip(reqs, outs):
        np.testing.assert_array_equal(o, eng.generate(r[None], 4)[0][0])
    with pytest.raises(ValueError):
        sched.submit(np.zeros((0,), np.int64), 4)
    with pytest.raises(ValueError):
        sched.submit(np.ones((MAX_LEN,), np.int64), 4)
