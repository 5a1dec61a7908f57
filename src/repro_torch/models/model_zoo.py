"""Model zoo: configs, reduced smoke configs, seeded parameters, the
converter from the reference's parameter tree, and the load-time weight
pack (paper lever 2 applied to a whole model)."""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from repro_torch import gemm as gemm_api
from repro_torch.configs.base import ModelConfig
from repro_torch.core import packing
from repro_torch.device import resolve_device
from repro_torch.models import transformer

# Architectures this package runs (the dense GQA family's deepseek-7b).
ARCHS = {"deepseek-7b": "deepseek_7b"}

# The paper's Table 3: twelve LLM prefill GEMMs at M = S = 128, as
# (model, op, N, K).
PAPER_GEMM_SHAPES = [
    ("gpt2-style", "qkv", 2048, 2048),
    ("gpt2-style", "ffn1", 8192, 2048),
    ("gpt2-style", "ffn2", 2048, 8192),
    ("gpt2-style", "lm_head", 60000, 2048),
    ("tinyllama-1.1b", "qkv", 2048, 2048),
    ("tinyllama-1.1b", "ffn1", 5632, 2048),
    ("tinyllama-1.1b", "ffn2", 2048, 5632),
    ("tinyllama-1.1b", "lm_head", 32000, 2048),
    ("llama-7b", "qkv", 4096, 4096),
    ("llama-7b", "ffn1", 11008, 4096),
    ("llama-7b", "ffn2", 4096, 11008),
    ("llama-7b", "lm_head", 32000, 4096),
]
PAPER_M = 128


def list_archs() -> list[str]:
    return list(ARCHS)


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported; choose from "
                       f"{list(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[name]}").CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving smoke config: tiny widths, same structure (the
    reference's reduction for the dense GQA family)."""
    kw: dict = dict(name=cfg.name + "-smoke", num_layers=2, d_model=64,
                    vocab_size=128, num_heads=4,
                    num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
                    head_dim=16)
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.window is not None:
        kw.update(window=32)
    return dataclasses.replace(cfg, **kw)


def build(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return transformer.init_params(cfg, gen, dev)


# ------------------------------------------------- reference parameters
def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # numpy keeps bf16 as an extension
        t = torch.from_numpy(np.array(a.view(np.int16)))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _is_pack(node) -> bool:
    """A reference pack (``PackedWeight`` or ``QuantizedPackedWeight``,
    its arrays as numpy), recognised by its fields."""
    return hasattr(node, "data") and hasattr(node, "block_k")


def _convert_pack(node, dev, layer=None):
    """A reference pack -> this package's, with the same codes, scales and
    metadata; ``layer`` takes one layer of a stacked pack."""
    def arr(a):
        a = np.asarray(a)
        return _tensor(a if layer is None else a[layer], dev)

    kw = dict(data=arr(node.data), n=int(node.n), k=int(node.k),
              block_n=int(node.block_n), block_k=int(node.block_k),
              n_splits=tuple(int(s) for s in node.n_splits))
    if getattr(node, "scales", None) is None:
        return packing.PackedWeight(**kw)
    from repro_torch.quant.formats import QuantizedPackedWeight
    return QuantizedPackedWeight(scales=arr(node.scales), fmt=str(node.fmt),
                                 sparsity=float(node.sparsity), **kw)


def convert_params(np_tree, device=None) -> dict:
    """The reference's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) -> this package's parameters.

    Layouts are kept ([K, N] for ``x @ w``); the reference's layer stack
    (every leaf under ``"layers"`` has a leading layer axis) becomes a
    list of per-layer dicts.  A packed tree (the reference engine's
    ``params``) carries its packs across, quantized ones included, as
    this package's packs with the same bytes."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if _is_pack(node):
            return _convert_pack(node, dev)
        return _tensor(node, dev)

    out = {}
    for key, node in np_tree.items():
        if key != "layers":
            out[key] = conv(node)
            continue
        first = next(iter(_leaves(node)))
        n_layers = len(first.data if _is_pack(first) else first)

        def take(tree, i):
            if isinstance(tree, dict):
                return {k: take(v, i) for k, v in tree.items()}
            if _is_pack(tree):
                return _convert_pack(tree, dev, layer=i)
            return _tensor(np.asarray(tree)[i], dev)

        out["layers"] = [take(node, i) for i in range(n_layers)]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------- load-time pack (lever 2)
# 2-D projection weights that run through the panel GEMM when packed.
_PACKABLE = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}

# Horizontal fusion groups: same-input projections concatenated along N
# into ONE pack, so one kernel pass streams the activations once.  The
# fused key is what the layers branch on; glu groups combine in the
# kernel's store step, so their pack blocks budget for two accumulators.
_FUSE_GROUPS = (
    (("wq", "wk", "wv"), "wqkv", None),
    (("w_gate", "w_up"), "w_gate_up", "glu"),
)


# keep_fp32 aliases: role names -> the parameter keys they pin.
_KEEP_FP32_ALIASES = {"head": ("lm_head",), "embed": ("embed",)}


def _resolve_keep_fp32(keep_fp32) -> frozenset:
    names: set[str] = set()
    for entry in keep_fp32 or ():
        names.update(_KEEP_FP32_ALIASES.get(entry, (entry,)))
    return frozenset(names)


def _move_pack(pw: packing.PackedWeight, dev):
    if dev is None:
        return pw
    kw = dict(data=pw.data.to(dev))
    if getattr(pw, "scales", None) is not None:
        kw["scales"] = pw.scales.to(dev)
    return dataclasses.replace(pw, **kw)


def pack_for_inference(cfg: ModelConfig, params, *, fuse: bool = True,
                       device=None, consume: bool = False,
                       quant: str | None = None,
                       keep_fp32=("head", "embed")) -> dict:
    """Pack every projection weight once at model load (paper §3.2).

    Each weight's (block_n, block_k) is the dispatch policy's
    (``gemm.pack_blocks`` at the paper's ``PAPER_M`` = 128 rows, in the
    weight's pack format).  ``fuse`` packs Q/K/V and gate+up as fused
    groups.  ``device`` places every leaf there before it is packed.
    ``consume=True`` removes each raw weight from ``params`` as soon as
    its pack exists, so a full-size model is never held raw and packed at
    once (a pack that needs no padding shares the raw weight's storage;
    fused, padded and quantized packs are new tensors).

    ``quant`` ("int8" | "ternary") quantizes every projection at pack
    time except the roles ``keep_fp32`` names ("head" -> ``lm_head``,
    "embed" -> the embedding table, or literal parameter names), which
    keep fp32 packs; a fused group quantizes only when none of its
    members is kept.  Each quantized pack is measured and gated by the
    error ledger as it is made.  A leaf that is already a pack (a tree
    carried across by ``convert_params``) is kept as it is."""
    dev = None if device is None else torch.device(device)
    keep = _resolve_keep_fp32(keep_fp32)
    if quant is not None:
        from repro_torch.quant.formats import _check_fmt
        _check_fmt(quant)

    def move(t):
        return t if dev is None else t.to(dev)

    def blocks_for(n, k, epilogue=None, fmt=None):
        return gemm_api.pack_blocks(n, k, m_hint=PAPER_M,
                                    epilogue=epilogue,
                                    weight_format=fmt or "fp32")

    def walk(node: dict) -> dict:
        out, done = {}, set()
        if fuse:
            for group, fused_name, glu in _FUSE_GROUPS:
                if not all(g in node for g in group):
                    continue
                parts = [move(node[g]) for g in group]
                if consume:
                    for g in group:
                        del node[g]
                fmt = quant if (quant and not keep.intersection(group)) \
                    else None
                spec = gemm_api.EpilogueSpec(glu=cfg.act) if glu else None
                bn, bk = blocks_for(sum(int(w.shape[-1]) for w in parts),
                                    parts[0].shape[-2], epilogue=spec,
                                    fmt=fmt)
                out[fused_name] = packing.pack_fused(parts, block_n=bn,
                                                     block_k=bk, quant=fmt)
                done.update(group)
                del parts
        for key in list(node):
            if key in done:
                continue
            v = node[key]
            if isinstance(v, dict):
                out[key] = walk(v)
            elif isinstance(v, list):
                out[key] = [walk(lp) for lp in v]
            elif isinstance(v, packing.PackedWeight):
                out[key] = _move_pack(v, dev)
            elif key in _PACKABLE and v.dim() == 2:
                v = move(v)
                if consume:
                    del node[key]
                k, n = v.shape
                fmt = quant if (quant and key not in keep) else None
                bn, bk = blocks_for(n, k, fmt=fmt)
                out[key] = packing.pack(v, block_n=bn, block_k=bk,
                                        quant=fmt)
            else:
                out[key] = move(v)
        return out

    return walk(params)
