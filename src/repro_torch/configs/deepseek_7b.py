"""deepseek-7b [dense]: llama-arch.  30L d_model=4096 32H (kv=32)
d_ff=11008 vocab=102400 [arXiv:2401.02954; hf].

The paper-representative arch: its projection GEMMs are the paper's
Llama-7B shape class (QKV (4096,4096), FFN1 (11008,4096), FFN2
(4096,11008)).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    source="arXiv:2401.02954; hf",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    attention_kind="gqa",
    compute_dtype="bfloat16",
)
