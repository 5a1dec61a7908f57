"""Serving engine: the paper's deployment discipline as a class.

``__init__`` is the untimed model-load phase: every projection weight is
packed once (paper §3.2) on the engine's device, quantized at pack time
when the engine serves a quantized format (``quant=``).  ``prefill`` /
``decode`` then pay only the compute loop; ``generate`` runs them per
request batch, and ``serve`` runs real continuous batching
(``runtime/batching``) over a paged KV cache, with outputs equal to
per-request greedy ``generate``.  Every step runs under the engine's GEMM
backend (``cuda`` on a CUDA device, ``plain`` on the CPU); decode steps
also run inside ``gemm.decode_lane()``, so their plans take the decode
arm (8-row panels, split-K).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import gemm as gemm_api
from repro_torch.device import resolve_device
from repro_torch.models import model_zoo, transformer
from repro_torch.quant.formats import QuantizedPackedWeight
from repro_torch.runtime.batching import _sync


@dataclasses.dataclass
class GenStats:
    """Token accounting for ``generate``: ``prefill_tokens`` counts prompt
    tokens processed, ``decode_tokens`` tokens emitted (rows x
    max_new_tokens, the prefill-sampled first token included).  Phase
    times end in a device sync.  ``quant`` is the engine's quantized
    format (None: fp32), ``quant_density`` the mean occupied-group
    fraction of its quantized packs (1.0 for the dense layouts; None
    without quantized packs) and ``quant_sparse_packs`` how many are on
    the compressed sparse-ternary layout (not ported yet: always 0)."""
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    fused: bool | None = None
    quant: str | None = None
    quant_density: float | None = None
    quant_sparse_packs: int = 0
    plan_cache: tuple | None = None
    vmem_clamped_plans: int = 0

    @property
    def prefill_tps(self):
        return self.prefill_tokens / max(self.prefill_s, 1e-9)

    @property
    def decode_tps(self):
        return self.decode_tokens / max(self.decode_s, 1e-9)


def _any_quantized(node) -> bool:
    if isinstance(node, dict):
        return any(_any_quantized(v) for v in node.values())
    if isinstance(node, list):
        return any(_any_quantized(v) for v in node)
    return isinstance(node, QuantizedPackedWeight)


class Engine:
    def __init__(self, cfg, params, *, max_len: int = 2048,
                 backend: str | None = None, fuse: bool = True, device=None,
                 consume: bool = False, quant: str | None = None,
                 keep_fp32=("head", "embed")):
        """``device``: CUDA unless the caller asks for the CPU; ``params``
        are moved there as they are packed.  ``backend`` pins the GEMM
        backend (default: ``cuda`` on a CUDA device, ``plain`` on the
        CPU).  ``fuse`` packs Q/K/V and gate+up as fused groups.
        ``consume=True`` lets the pack release each raw weight of
        ``params`` as soon as its pack exists (full-size models).

        ``quant`` ("int8" | "ternary") serves the model on quantized
        packs: every projection quantizes at load except the
        ``keep_fp32`` roles (default: the LM head and the embeddings),
        its GEMMs run the dequant-fused kernels, and the error ledger
        gates each pack.  (The engine always packs, so the reference's
        "quant requires packed" case cannot arise.)"""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.fused = fuse
        self.quant = quant
        self.backend = backend or ("cuda" if self.device.type == "cuda"
                                   else "plain")
        gemm_api.get_backend(self.backend)          # fail fast on a typo
        self.params = model_zoo.pack_for_inference(
            cfg, params, fuse=fuse, device=self.device, consume=consume,
            quant=quant, keep_fp32=keep_fp32)
        # every quantized pack is on a dense layout: all groups occupied
        self.quant_density = 1.0 if _any_quantized(self.params) else None

    def _stamp(self, stats):
        stats.fused = self.fused
        stats.quant = self.quant
        stats.quant_density = self.quant_density

    @contextlib.contextmanager
    def _scope(self, decode: bool):
        with torch.no_grad(), gemm_api.use_backend(self.backend), \
                (gemm_api.decode_lane() if decode
                 else contextlib.nullcontext()):
            yield

    # ------------------------------------------------------------- steps
    def prefill(self, inputs):
        """inputs: [B, S] token ids.  Returns (last_logits [B, V], cache)."""
        with self._scope(decode=False):
            return transformer.prefill(self.cfg, self.params,
                                       self._tokens(inputs),
                                       max_len=self.max_len)

    def decode(self, cache, tokens):
        with self._scope(decode=True):
            return transformer.decode_step(self.cfg, self.params, cache,
                                           self._tokens(tokens))

    def _paged_cache(self, pages, page_table, lens, write_mask=None):
        layers = [{name: pool[li] for name, pool in pages.items()}
                  for li in range(self.cfg.num_layers)]
        cache = {"layers": layers, "page_table": page_table, "lens": lens}
        if write_mask is not None:
            cache["write_mask"] = write_mask
        return cache

    def prefill_chunk(self, pages, page_table, lens, tokens, logit_index,
                      *, page_size: int):
        """One chunked-prefill step: write ``tokens`` [1, C] into one
        slot's pages (in place) at its current length.  Returns (greedy
        token of chunk row ``logit_index``, as a device scalar, pages)."""
        with self._scope(decode=False):
            logits, _ = transformer.prefill_chunk(
                self.cfg, self.params,
                self._paged_cache(pages, page_table, lens),
                self._tokens(tokens), page_size=page_size,
                logit_index=int(logit_index))
        return torch.argmax(logits[0]), pages

    def decode_step(self, pages, page_table, lens, write_mask, last_tokens,
                    *, page_size: int):
        """One decode step for the whole pool: ``last_tokens`` [slots] go
        back through the model at per-slot lengths; slots outside
        ``write_mask`` write nothing and keep their token.  Returns (next
        last tokens [slots], pages)."""
        with self._scope(decode=True):
            logits, _ = transformer.paged_decode_step(
                self.cfg, self.params,
                self._paged_cache(pages, page_table, lens, write_mask),
                self._tokens(last_tokens)[:, None], page_size=page_size)
        toks = torch.argmax(logits, dim=-1)
        return torch.where(write_mask, toks, last_tokens), pages

    def _tokens(self, t):
        return torch.as_tensor(np.asarray(t) if not isinstance(
            t, torch.Tensor) else t, device=self.device).long()

    # ------------------------------------------------------------ generate
    def generate(self, prompts, max_new_tokens: int, *,
                 stats: GenStats | None = None):
        """Greedy continuation of ``prompts`` [B, S0].  Returns (tokens
        [B, max_new_tokens] on the device, stats)."""
        stats = stats if stats is not None else GenStats()
        self._stamp(stats)
        prompts = self._tokens(prompts)
        b, s0 = prompts.shape
        t0 = time.perf_counter()
        logits, cache = self.prefill(prompts)
        tok = torch.argmax(logits, dim=-1)
        _sync(self.device)
        stats.prefill_s += time.perf_counter() - t0
        stats.prefill_tokens += b * s0
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            logits, cache = self.decode(cache, tok[:, None])
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        _sync(self.device)
        stats.decode_s += time.perf_counter() - t0
        stats.decode_tokens += b * max_new_tokens
        stats.plan_cache = gemm_api.plan_cache_info()
        stats.vmem_clamped_plans = gemm_api.vmem_clamped_count()
        return torch.stack(out, dim=1), stats

    # ------------------------------------------------ continuous batching
    def serve(self, requests: list, *, batch_slots: int, max_new_tokens,
              prefill_chunk: int = 32, page_size: int = 16,
              num_pages: int | None = None, check_invariants: bool = False):
        """Continuous batching (greedy): slot refill mid-generation, paged
        KV cache, chunked prefill admission.  ``requests``: int prompt
        arrays at their true lengths; ``max_new_tokens``: int or one per
        request.  Returns (generated tokens per request, ServeStats)."""
        from repro_torch.runtime.batching import ContinuousBatchingScheduler
        sched = ContinuousBatchingScheduler(
            self, batch_slots=batch_slots, prefill_chunk=prefill_chunk,
            page_size=page_size, num_pages=num_pages,
            check_invariants=check_invariants)
        outs, stats = sched.run(requests, max_new_tokens)
        self._stamp(stats)
        stats.plan_cache = gemm_api.plan_cache_info()
        stats.vmem_clamped_plans = gemm_api.vmem_clamped_count()
        return outs, stats

