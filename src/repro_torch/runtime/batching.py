"""Continuous batching: a slot-refill scheduler with chunked prefill
admission over a paged KV cache.

A static pool of ``batch_slots`` slots stays alive across requests:
requests queue FIFO; a slot whose request finishes is freed and refilled
at once; new prompts prefill in chunks padded to a ``gemm.bucket_m``
width, interleaved with decode steps; decode always runs the whole pool
``[batch_slots, 1]`` with per-slot lengths and a write mask.  Per tick:
admit while the page budget holds, run one prefill chunk for the
earliest-admitted prefilling slot, run one decode step for every decoding
slot.  Tokens stay on the device until the end of the run.  Outputs equal
per-request greedy ``Engine.generate`` token for token.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch import gemm as gemm_api
from repro_torch.runtime import kv_cache as KV


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------ stats
@dataclasses.dataclass
class RequestStats:
    """Per-request serving latency record (seconds / tokens)."""
    rid: int
    prompt_len: int
    new_tokens: int
    queue_wait_s: float          # enqueue -> admitted to a slot
    ttft_s: float                # enqueue -> first token emitted
    total_s: float               # enqueue -> finished
    decode_tps: float            # new_tokens over first-token -> finish


@dataclasses.dataclass
class ServeStats:
    """Aggregate and per-request serving stats.  ``prefill_tokens`` counts
    true prompt tokens computed (never chunk padding); ``decode_tokens``
    counts tokens emitted (the prefill-sampled first token included).
    Tick times (and so the phase rates) are host times of dispatch, with
    no sync per step; ``wall_s`` ends in a device sync."""
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    wall_s: float = 0.0
    fused: bool | None = None
    quant: str | None = None            # as GenStats
    quant_density: float | None = None
    quant_sparse_packs: int = 0
    plan_cache: tuple | None = None
    vmem_clamped_plans: int = 0
    requests: list[RequestStats] = dataclasses.field(default_factory=list)
    prefill_tick_ms: list = dataclasses.field(default_factory=list)
    decode_tick_ms: list = dataclasses.field(default_factory=list)

    @property
    def prefill_tps(self):
        return self.prefill_tokens / max(self.prefill_s, 1e-9)

    @property
    def decode_tps(self):
        return self.decode_tokens / max(self.decode_s, 1e-9)

    @property
    def total_tps(self):
        """Emitted tokens over wall time."""
        return self.decode_tokens / max(self.wall_s, 1e-9)

    @property
    def decode_ticks(self) -> int:
        return len(self.decode_tick_ms)


@dataclasses.dataclass
class _Request:
    rid: int
    tokens: np.ndarray
    max_new: int
    t_enqueue: float
    t_admit: float = 0.0
    t_first: float | None = None


class _Slot:
    __slots__ = ("request", "n_prefilled", "n_emitted", "first_tok",
                 "steps", "order")

    def __init__(self):
        self.request: _Request | None = None
        self.n_prefilled = 0
        self.n_emitted = 0
        self.first_tok = None      # device scalar from the final chunk
        self.steps: list[int] = []  # indices into the decode history
        self.order = -1            # admission sequence number

    @property
    def prefill_done(self):
        return (self.request is not None
                and self.n_prefilled == len(self.request.tokens))


# -------------------------------------------------------------- scheduler
class ContinuousBatchingScheduler:
    """Drives an engine's paged ``prefill_chunk`` / ``decode_step`` over a
    FIFO request queue with slot refill.

    ``engine`` needs ``cfg``, ``max_len``, ``device`` and the two paged
    step methods.  ``num_pages`` below the dense-equivalent total turns on
    paging pressure: a request is admitted only when its whole worst-case
    footprint fits beside the outstanding growth of every live slot, which
    keeps the pool deadlock-free.  ``trace`` records the scheduler's
    events; ``run`` ends with the pool's leak audit on every exit path."""

    def __init__(self, engine, *, batch_slots: int, prefill_chunk: int = 32,
                 page_size: int = 16, num_pages: int | None = None,
                 check_invariants: bool = False):
        cfg = engine.cfg
        self.engine = engine
        self.cfg = cfg
        self.device = torch.device(getattr(engine, "device", "cpu"))
        self.batch_slots = batch_slots
        self.page_size = page_size
        # static admission width: a plan bucket, so every chunk of a
        # mixed-length stream resolves the same GEMM plan keys
        self.chunk = gemm_api.bucket_m(prefill_chunk)
        self.check_invariants = check_invariants
        self.kv = KV.PagedKVCache(
            num_layers=cfg.num_layers, num_slots=batch_slots,
            max_len=engine.max_len, page_size=page_size,
            leaf_specs=KV.leaf_specs_for(cfg), num_pages=num_pages,
            device=self.device)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: collections.deque[_Request] = collections.deque()
        self.trace: list[tuple] = []
        self.stats = ServeStats()
        self._results: dict[int, np.ndarray] = {}
        self._next_rid = 0
        self._admit_seq = 0
        self._last = torch.zeros((batch_slots,), dtype=torch.long,
                                 device=self.device)
        self._history: list[torch.Tensor] = []
        self._pending: list[tuple] = []   # (rid, slot, first_tok, steps)

    # ------------------------------------------------------------ intake
    def submit(self, tokens, max_new: int) -> int:
        """Enqueue one request; returns its rid.  Raises ValueError for a
        request that could never be served."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        if tokens.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if tokens.size + max_new - 1 > self.engine.max_len:
            raise ValueError(
                f"prompt {tokens.size} + max_new {max_new} exceeds "
                f"engine max_len {self.engine.max_len}")
        need = KV.pages_for(tokens.size + max_new - 1, self.page_size)
        if need > self.kv.num_pages:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.kv.num_pages} -- it could never be admitted")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(_Request(rid, tokens, max_new,
                                   t_enqueue=time.perf_counter()))
        self.trace.append(("enqueue", rid))
        return rid

    # ------------------------------------------------------- page budget
    def _footprint(self, req: _Request) -> int:
        return KV.pages_for(len(req.tokens) + req.max_new - 1,
                            self.page_size)

    def _outstanding_growth(self) -> int:
        """Pages live slots may still demand before they finish."""
        return sum(self._footprint(sl.request) - self.kv.held(i)
                   for i, sl in enumerate(self.slots)
                   if sl.request is not None)

    # ------------------------------------------------------------- steps
    def _admit(self):
        for i, sl in enumerate(self.slots):
            if sl.request is not None or not self.queue:
                continue
            req = self.queue[0]
            need = self._footprint(req)
            if need + self._outstanding_growth() > self.kv.free_count:
                break                      # FIFO: never skip the head
            self.queue.popleft()
            req.t_admit = time.perf_counter()
            sl.request, sl.first_tok = req, None
            sl.n_prefilled, sl.n_emitted, sl.steps = 0, 0, []
            sl.order = self._admit_seq
            self._admit_seq += 1
            self.trace.append(("admit", req.rid, i))
            if self.check_invariants:
                self.kv.check_no_aliasing()

    def _timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def _prefill_step(self) -> bool:
        cands = [(sl.order, i) for i, sl in enumerate(self.slots)
                 if sl.request is not None and not sl.prefill_done]
        if not cands:
            return False
        _, i = min(cands)                  # earliest admitted first
        sl = self.slots[i]
        req = sl.request
        start = sl.n_prefilled
        # chunk-tail bucketing: the last chunk dispatches at the smallest
        # bucket that holds it instead of the full admission width
        rem = len(req.tokens) - start
        width = self.chunk if rem >= self.chunk else gemm_api.bucket_m(rem)
        end = min(start + width, len(req.tokens))
        final = end == len(req.tokens)
        self.kv.alloc(i, end)
        chunk = np.zeros((1, width), np.int64)
        chunk[0, :end - start] = req.tokens[start:end]
        (tok, pages), dt = self._timed(lambda: self.engine.prefill_chunk(
            self.kv.pages, self.kv.table_device([i]),
            self.kv.lens_device([i]),
            torch.from_numpy(chunk).to(self.device), end - start - 1,
            page_size=self.page_size))
        self.kv.pages = pages
        self.stats.prefill_s += dt
        self.stats.prefill_tick_ms.append(dt * 1e3)
        self.stats.prefill_tokens += end - start
        self.kv.lens[i] = end
        sl.n_prefilled = end
        self.trace.append(("prefill", req.rid, i, start, end))
        if final:
            # the first token stays on the device: it feeds the slot's
            # decode steps through the last-token row (a fresh tensor: the
            # previous one is a row of the decode history)
            self._last = self._last.clone()
            self._last[i] = tok
            sl.first_tok = tok
            req.t_first = time.perf_counter()
            self._emit(i)
        if self.check_invariants:
            self.kv.check_no_aliasing()
        return True

    def _decode_step(self) -> bool:
        dec = [i for i, sl in enumerate(self.slots) if sl.prefill_done]
        if not dec:
            return False
        for i in dec:
            self.kv.alloc(i, int(self.kv.lens[i]) + 1)
        mask = np.zeros((self.batch_slots,), bool)
        mask[dec] = True
        rids = tuple(self.slots[i].request.rid for i in dec)
        (last, pages), dt = self._timed(lambda: self.engine.decode_step(
            self.kv.pages, self.kv.table_device(), self.kv.lens_device(),
            torch.from_numpy(mask).to(self.device), self._last,
            page_size=self.page_size))
        self._last = last
        self.kv.pages = pages
        self.stats.decode_s += dt
        self.stats.decode_tick_ms.append(dt * 1e3)
        step_idx = len(self._history)
        self._history.append(last)
        self.trace.append(("decode", rids))
        for i in dec:
            self.kv.lens[i] += 1
            self.slots[i].steps.append(step_idx)
            self._emit(i)
        if self.check_invariants:
            self.kv.check_no_aliasing()
        return True

    def _emit(self, i: int):
        sl = self.slots[i]
        sl.n_emitted += 1
        self.stats.decode_tokens += 1
        if sl.n_emitted == sl.request.max_new:
            self._finish(i)

    def _finish(self, i: int) -> None:
        """Record the request in slot ``i`` as done, free its pages and
        recycle the slot."""
        sl = self.slots[i]
        req = sl.request
        self._pending.append((req.rid, i, sl.first_tok, tuple(sl.steps)))
        now = time.perf_counter()
        self.stats.requests.append(RequestStats(
            rid=req.rid, prompt_len=len(req.tokens), new_tokens=req.max_new,
            queue_wait_s=req.t_admit - req.t_enqueue,
            ttft_s=req.t_first - req.t_enqueue,
            total_s=now - req.t_enqueue,
            decode_tps=req.max_new / max(now - req.t_first, 1e-9)))
        self.trace.append(("finish", req.rid, i))
        freed = self.kv.free(i)
        self.trace.append(("free", i, tuple(freed)))
        sl.request, sl.first_tok = None, None
        sl.n_prefilled, sl.n_emitted, sl.steps = 0, 0, []

    def _materialize(self):
        """Copy the token history to the host once and assemble each
        request's tokens."""
        hist = (torch.stack(self._history).cpu().numpy() if self._history
                else np.zeros((0, self.batch_slots), np.int64))
        for rid, slot, first, steps in self._pending:
            toks = [int(first)] + [int(t) for t in hist[list(steps), slot]]
            self._results[rid] = np.asarray(toks, np.int32)
        self._pending.clear()

    # --------------------------------------------------------------- run
    def step(self) -> bool:
        """One tick: admit, one prefill chunk, one decode step.  Returns
        False once no work remains."""
        self._admit()
        did_p = self._prefill_step()
        did_d = self._decode_step()
        return did_p or did_d or bool(self.queue)

    def run(self, requests, max_new_tokens) -> tuple[list, ServeStats]:
        """Serve ``requests`` (int prompt arrays) to completion;
        ``max_new_tokens`` is an int or one per request.  Returns (the
        generated tokens per request, in submission order, and stats)."""
        n = len(requests)
        mn = ([int(max_new_tokens)] * n if np.isscalar(max_new_tokens)
              else [int(m) for m in max_new_tokens])
        if len(mn) != n:
            raise ValueError("max_new_tokens list must match requests")
        t0 = time.perf_counter()
        rids = [self.submit(r, m) for r, m in zip(requests, mn)]
        # every tick prefills a chunk or decodes >= 1 token, so this bound
        # is generous; reaching it means a scheduler bug, not load
        max_ticks = 10 + 2 * (sum(mn) + sum(
            -(-len(np.atleast_1d(r)) // self.chunk) for r in requests))
        try:
            for _ in range(max_ticks):
                if not self.step():
                    break
            else:
                raise RuntimeError(
                    f"scheduler made no progress in {max_ticks} ticks")
            self._materialize()
            _sync(self.device)
        finally:
            self.stats.wall_s += time.perf_counter() - t0
            for i, sl in enumerate(self.slots):
                if sl.request is not None:   # aborted run: release pages
                    self.kv.free(i)
                    sl.request = None
            self.queue.clear()
            self.kv.assert_all_free()
        return [self._results.get(r) for r in rids], self.stats
