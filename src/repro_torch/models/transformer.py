"""Decoder stack for the dense GQA family: one layer body serving the
prefill, decode, chunked-prefill and paged-decode phases.

Parameters keep the reference's layout (``[K, N]`` weights for
``x @ w``); the reference's stacked-layer ``lax.scan`` becomes a Python
loop over ``params["layers"]``, a list of per-layer dicts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.packing import PackedWeight
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def _check_supported(cfg):
    if cfg.family != "dense" or cfg.attention_kind != "gqa":
        raise NotImplementedError(
            f"the port runs the dense GQA family; got family="
            f"{cfg.family!r}, attention_kind={cfg.attention_kind!r}")
    if cfg.modality != "text":
        raise NotImplementedError("the port serves token models only")


# ----------------------------------------------------------------- params
def _init_layer(gen, cfg, dtype, device):
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=device)
    p = {"ln1": ones(),
         "attn": A.gqa_params(gen, cfg, dtype, device)}
    if cfg.post_norms:
        p["ln1_post"] = ones()
        p["ln2_post"] = ones()
    p["ln2"] = ones()
    d, f = cfg.d_model, cfg.d_ff
    p["ffn"] = {
        "w_gate": L.init_dense(gen, (d, f), dtype=dtype, device=device),
        "w_up": L.init_dense(gen, (d, f), dtype=dtype, device=device),
        "w_down": L.init_dense(gen, (f, d), dtype=dtype, device=device),
    }
    return p


def init_params(cfg, gen: torch.Generator, device) -> dict:
    """Random parameters drawn from ``gen`` (a generator on ``device``)."""
    _check_supported(cfg)
    dtype = cfg.pdtype
    params = {"embed": L.init_dense(gen, (cfg.vocab_size, cfg.d_model),
                                    scale=1.0, dtype=dtype, device=device)}
    params["layers"] = [_init_layer(gen, cfg, dtype, device)
                        for _ in range(cfg.num_layers)]
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                      device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense(gen, (cfg.d_model, cfg.vocab_size),
                                         dtype=dtype, device=device)
    return params


def window_pattern(cfg) -> np.ndarray:
    """Per-layer attention window (-1 = full attention)."""
    lyr = cfg.num_layers
    if cfg.local_global_period > 0:
        w = np.full((lyr,), -1, np.int32)
        for i in range(lyr):
            if i % cfg.local_global_period != cfg.local_global_period - 1:
                w[i] = cfg.window
        return w
    if cfg.window is not None:
        return np.full((lyr,), cfg.window, np.int32)
    return np.full((lyr,), -1, np.int32)


# ------------------------------------------------------------------ cache
def init_cache(cfg, batch: int, max_len: int, device) -> dict:
    """Dense decode cache: per layer ``k``/``v`` [B, max_len, Hkv, D]."""
    if cfg.resolved_cache_kind != "full":
        raise NotImplementedError("the port runs the full cache only")
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    layers = [{"k": torch.zeros(shape, dtype=cfg.kvdtype, device=device),
               "v": torch.zeros(shape, dtype=cfg.kvdtype, device=device)}
              for _ in range(cfg.num_layers)]
    return {"layers": layers, "index": 0}


# ------------------------------------------------------------------ layers
def _layer_forward(cfg, lp, x, *, window_l, positions, cache_l, cache_index,
                   page_size=None):
    """One decoder layer; the cache (if any) is updated in place."""
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps, cfg.norm_plus_one)
    out, _ = A.gqa_attention(lp["attn"], cfg, h, positions=positions,
                             window=window_l, cache=cache_l,
                             cache_index=cache_index, page_size=page_size)
    if cfg.post_norms:
        out = L.rms_norm(out, lp["ln1_post"], cfg.norm_eps,
                         cfg.norm_plus_one)
    x = x + out
    h2 = L.rms_norm(x, lp["ln2"], cfg.norm_eps, cfg.norm_plus_one)
    ffn = lp["ffn"]
    if "w_gate_up" in ffn:
        # fused gate+up pack: one pass, glu combine in the store step; in
        # pre-norm blocks the residual add rides the down-projection
        if cfg.post_norms:
            out2 = L.swiglu_fused(h2, ffn["w_gate_up"], ffn["w_down"],
                                  cfg.act)
            out2 = L.rms_norm(out2, lp["ln2_post"], cfg.norm_eps,
                              cfg.norm_plus_one)
            return x + out2
        return L.swiglu_fused(h2, ffn["w_gate_up"], ffn["w_down"], cfg.act,
                              residual=x)
    out2 = L.swiglu(h2, ffn["w_gate"], ffn["w_up"], ffn["w_down"], cfg.act)
    if cfg.post_norms:
        out2 = L.rms_norm(out2, lp["ln2_post"], cfg.norm_eps,
                          cfg.norm_plus_one)
    return x + out2


# ----------------------------------------------------------------- forward
def forward(cfg, params, inputs, *, cache=None, mode: str = "prefill",
            logits_mode: str = "all", page_size=None, logit_index=None):
    """Run the stack on int tokens [B, S].  Returns (logits, cache).

    A paged cache (dict with ``page_table``/``lens``, see
    runtime/kv_cache) takes per-slot positions ``lens[b] + i``;
    ``logits_mode="index"`` computes logits for the single row
    ``logit_index`` (the last real row of a padded prefill chunk).  The
    cache is updated in place and returned."""
    _check_supported(cfg)
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port runs prefill and decode")
    if logits_mode not in ("all", "last", "none", "index"):
        raise ValueError(f"logits_mode {logits_mode!r}")
    x = L.embed_tokens(params["embed"], inputs).to(cfg.cdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype)
    paged = cache is not None and "page_table" in cache
    s = x.shape[1]
    dev = x.device
    if paged:
        if page_size is None:
            raise ValueError("paged cache needs page_size")
        cache_index = None
        positions = (cache["lens"].long()[:, None]
                     + torch.arange(s, device=dev)[None])
    else:
        cache_index = cache["index"] if cache is not None else 0
        positions = torch.arange(s, device=dev) + (
            cache_index if mode == "decode" else 0)
    windows = window_pattern(cfg)
    for li, lp in enumerate(params["layers"]):
        c_l = None
        if cache is not None:
            c_l = dict(cache["layers"][li])
            if paged:
                c_l.update({k: cache[k] for k in
                            ("page_table", "lens", "write_mask")
                            if k in cache})
        w_l = int(windows[li])
        x = _layer_forward(cfg, lp, x, window_l=None if w_l < 0 else w_l,
                           positions=positions, cache_l=c_l,
                           cache_index=cache_index, page_size=page_size)

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_plus_one)
    if logits_mode == "last":
        x = x[:, -1:]
    elif logits_mode == "index":
        x = x[:, logit_index:logit_index + 1]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = None
    if logits_mode != "none":
        if isinstance(head, PackedWeight) and cfg.logit_softcap:
            logits = L.linear(x, head, softcap=cfg.logit_softcap,
                              out_dtype=torch.float32)
        else:
            logits = L.softcap(L.linear(x, head).float(), cfg.logit_softcap)
    if cache is not None and not paged:
        cache["index"] = cache_index + s
    return logits, cache


def prefill(cfg, params, inputs, *, max_len: int):
    """Batched prefill: build the cache, return last-token logits."""
    cache = init_cache(cfg, inputs.shape[0], max_len, inputs.device)
    logits, cache = forward(cfg, params, inputs, cache=cache, mode="prefill",
                            logits_mode="last")
    return logits[:, 0], cache


def decode_step(cfg, params, cache, tokens):
    """One decode step.  tokens: [B, 1] ids."""
    logits, cache = forward(cfg, params, tokens, cache=cache, mode="decode",
                            logits_mode="last")
    return logits[:, 0], cache


# -------------------------------------------- continuous-batching steps
def prefill_chunk(cfg, params, cache, tokens, *, page_size, logit_index):
    """One chunked-prefill step against a paged cache: tokens [B, C] (a
    padded chunk); returns (logits [B, V] of row ``logit_index``, cache)."""
    logits, cache = forward(cfg, params, tokens, cache=cache, mode="prefill",
                            logits_mode="index", logit_index=logit_index,
                            page_size=page_size)
    return logits[:, 0], cache


def paged_decode_step(cfg, params, cache, tokens, *, page_size):
    """One decode step for the whole slot pool against a paged cache;
    slots outside ``cache['write_mask']`` write nothing."""
    logits, cache = forward(cfg, params, tokens, cache=cache, mode="decode",
                            logits_mode="last", page_size=page_size)
    return logits[:, 0], cache
