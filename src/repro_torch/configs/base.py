"""Model configuration schema, with torch dtypes.

The port of ``repro.configs.base.ModelConfig`` for the dense GQA family,
the only family this package runs; field names and defaults are the
reference's, so a config compares field by field with its JAX twin.
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense (the only family ported)
    modality: str = "text"
    source: str = ""                 # provenance tag
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    attention_kind: str = "gqa"      # gqa (the only kind ported)
    window: int | None = None        # uniform sliding window (SWA)
    local_global_period: int = 0     # >0: alternate local(window)/global
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    attn_scale: float | None = None
    rope_theta: float = 10000.0
    act: str = "silu"                # silu | gelu
    norm_eps: float = 1e-6
    norm_plus_one: bool = False      # gemma-style (1 + scale) RMSNorm
    post_norms: bool = False         # post-attn/post-ffn norms
    embed_scale: bool = False        # scale embeddings by sqrt(d)
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    cache_kind: str = "auto"         # auto | full
    cache_dtype: str = "bfloat16"

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def kvdtype(self) -> torch.dtype:
        return _DTYPES[self.cache_dtype]

    @property
    def resolved_cache_kind(self) -> str:
        if self.cache_kind != "auto":
            return self.cache_kind
        windowed_only = (self.window is not None
                         and self.local_global_period == 0)
        return "window" if windowed_only else "full"

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, v = self.d_model, self.vocab_size
        n = v * d if self.tie_embeddings else 2 * v * d
        per = 2 * d + (2 * d if self.post_norms else 0)
        per += d * self.num_heads * self.head_dim * 2        # wq, wo
        per += d * self.num_kv_heads * self.head_dim * 2     # wk, wv
        per += d * self.d_ff * 3
        return n + self.num_layers * per
