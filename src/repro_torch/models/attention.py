"""GQA attention over the full and the paged cache.

``blocked_attention`` is the forward of the reference's flash attention
(``repro.models.flash_vjp._fwd_core``): an online softmax over KV chunks
of 512, in fp32.  It is written in elementwise torch ops and
``layers.tree_sum`` rather than in matrix products, so that every score
and every output row is a function of its own query row and the cache
only: neither M nor the other rows of the batch change a bit of it, and
continuous batching (``serve``) matches per-request ``generate`` exactly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.panel_gemm import round_once
from repro_torch.models.layers import tree_sum

_NEG = -1e30

# Elements of the largest [rows, chunk, D] product one step materialises;
# query rows are processed in pieces of at most this size (rows are
# independent, so the piece size does not change any result).
_PRODUCT_BUDGET = 1 << 26


def _exp(x):
    return round_once(torch.exp, x)


def _attend_rows(qg, k, v, k_pos, q_pos, *, scale, causal, window, softcap,
                 chunk):
    """Online softmax for the query rows ``qg`` [B, Hkv, G, S, D] (fp32)
    over ``k``/``v`` [B, T, Hkv, *] with T a multiple of ``chunk``."""
    b, hkv, g, s, _ = qg.shape
    dv = v.shape[-1]
    m = torch.full((b, hkv, g, s), _NEG, dtype=torch.float32,
                   device=qg.device)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((b, hkv, g, s, dv), dtype=torch.float32,
                      device=qg.device)
    qp = q_pos[:, :, None]                                   # [B, S, 1]
    for i in range(k.shape[1] // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_c = k[:, sl].float().permute(0, 2, 1, 3)           # [B,Hkv,c,D]
        v_c = v[:, sl].float().permute(0, 2, 3, 1)           # [B,Hkv,Dv,c]
        kp = k_pos[:, None, sl]                              # [B, 1, c]
        s_blk = tree_sum(qg[..., None, :] * k_c[:, :, None, None]) * scale
        if softcap is not None:
            s_blk = softcap * round_once(torch.tanh, s_blk / softcap)
        mask = kp >= 0
        if causal:
            mask = mask & (qp >= kp)
        if window is not None:
            mask = mask & ((window <= 0) | ((qp - kp) < window))
        mask = mask[:, None, None]                           # [B,1,1,S,c]
        s_blk = torch.where(mask, s_blk, _NEG)
        m_new = torch.maximum(m, s_blk.amax(dim=-1))
        p = torch.where(mask, _exp(s_blk - m_new[..., None]), 0.0)
        alpha = _exp(m - m_new)
        l = l * alpha + tree_sum(p)
        pv = tree_sum(p[..., None, :] * v_c[:, :, None, None])
        acc = acc * alpha[..., None] + pv
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return acc / l[..., None]                                # [B,Hkv,G,S,Dv]


def blocked_attention(q, k, v, *, scale: float, causal: bool = True,
                      window=None, softcap: float | None = None,
                      kv_len=None, q_offset=0, k_pos=None,
                      chunk: int = 512) -> torch.Tensor:
    """q [B, S, H, D]; k, v [B, T, Hkv, D/Dv].  ``kv_len`` masks the cache
    tail, ``q_offset`` (scalar or [B]) places query row 0, ``k_pos`` [B, T]
    gives explicit key positions (-1 = empty); ``window`` <= 0 or None
    means full attention.  Returns [B, S, H, Dv] in q's dtype."""
    b, s, h, d = q.shape
    _, t, hkv, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    chunk = min(chunk, t)
    pad = (-t) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if k_pos is not None:
            k_pos = F.pad(k_pos, (0, pad), value=-1)
    tp = t + pad
    dev = q.device
    if k_pos is None:
        kv_len = t if kv_len is None else kv_len
        k_pos = torch.arange(tp, device=dev)[None].expand(b, tp)
        k_pos = torch.where(k_pos < kv_len, k_pos, -1)
    q_off = torch.as_tensor(q_offset, device=dev).long()
    if q_off.dim() == 0:
        q_off = q_off.expand(b)
    q_pos = q_off[:, None] + torch.arange(s, device=dev)[None]   # [B, S]
    qg = q.reshape(b, s, hkv, g, d).float().permute(0, 2, 3, 1, 4)
    rows = max(1, _PRODUCT_BUDGET // max(1, b * h * chunk * max(d, dv)))
    outs = [_attend_rows(qg[:, :, :, r:r + rows], k, v, k_pos,
                         q_pos[:, r:r + rows], scale=scale, causal=causal,
                         window=window, softcap=softcap, chunk=chunk)
            for r in range(0, s, rows)]
    out = torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)        # [B,S,Hkv,G,Dv]
    return out.reshape(b, s, h, dv).to(q.dtype)


# --------------------------------------------------------------------- GQA
def gqa_params(gen: torch.Generator, cfg, dtype, device):
    """Weights for one GQA attention block, [K, N] for ``x @ w``."""
    from repro_torch.models.layers import init_dense
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": init_dense(gen, (d, h * hd), dtype=dtype, device=device),
        "wk": init_dense(gen, (d, hkv * hd), dtype=dtype, device=device),
        "wv": init_dense(gen, (d, hkv * hd), dtype=dtype, device=device),
        "wo": init_dense(gen, (h * hd, d), dtype=dtype, device=device),
    }


def _update_full_cache(cache, k, v, cache_index, s):
    """Write the new keys/values at ``cache_index`` IN PLACE (the
    reference returns an updated copy; the port overwrites the buffers it
    owns) and return the whole cache view."""
    cache["k"][:, cache_index:cache_index + s] = k.to(cache["k"].dtype)
    cache["v"][:, cache_index:cache_index + s] = v.to(cache["v"].dtype)
    return cache, cache["k"], cache["v"], None, cache_index + s, cache_index


def _update_paged_cache(cache, k, v, page_size):
    """Scatter the new tokens of every slot at its own length (in place),
    then gather the logical-order dense view.  The view has the dense
    cache's length and chunking, and masked positions contribute exact
    zeros, so attention here equals attention over the dense cache."""
    from repro_torch.runtime import kv_cache as KV
    pt, lens = cache["page_table"], cache["lens"]
    wm = cache.get("write_mask")
    s = k.shape[1]
    KV.paged_update(cache["pages_k"], k, pt, lens, page_size, write_mask=wm)
    KV.paged_update(cache["pages_v"], v, pt, lens, page_size, write_mask=wm)
    k_d = KV.paged_gather(cache["pages_k"], pt, page_size)
    v_d = KV.paged_gather(cache["pages_v"], pt, page_size)
    t_view = k_d.shape[1]
    k_pos = torch.arange(t_view, device=k.device)[None, :]
    k_pos = torch.where(k_pos < lens[:, None] + s, k_pos, -1)
    return cache, k_d, v_d, k_pos, None, lens


def gqa_attention(p, cfg, x, *, positions, window=None, cache=None,
                  cache_index=None, page_size=None):
    """GQA attention.  ``cache``: dict(k=[B,T,Hkv,D], v=...) written at
    ``cache_index``, or a paged view (pages_k/pages_v + page_table/lens).
    Returns (out, cache)."""
    from repro_torch.models import layers as L
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "wqkv" in p:
        q, k, v = L.fused_linear(x, p["wqkv"])
    else:
        q, k, v = (L.linear(x, p["wq"]), L.linear(x, p["wk"]),
                   L.linear(x, p["wv"]))
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    scale = cfg.attn_scale if cfg.attn_scale else hd ** -0.5

    new_cache, k_pos, kv_len, q_offset = None, None, s, 0
    if cache is not None:
        if "pages_k" in cache:
            new_cache, k, v, k_pos, kv_len, q_offset = _update_paged_cache(
                cache, k, v, page_size)
        else:
            new_cache, k, v, k_pos, kv_len, q_offset = _update_full_cache(
                cache, k, v, cache_index, s)

    out = blocked_attention(
        q, k, v, scale=scale, causal=True, window=window,
        softcap=cfg.attn_softcap, kv_len=kv_len, q_offset=q_offset,
        k_pos=k_pos)
    return L.linear(out.reshape(b, s, h * hd), p["wo"]), new_cache
