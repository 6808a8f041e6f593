"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936 — GQA, QKV bias. [arXiv:2407.10671; hf]"""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151_936,
    qkv_bias=True, norm="rmsnorm", act="silu",
    rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen2-smoke", family="dense",
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
    d_ff=144, vocab=512,
    qkv_bias=True, norm="rmsnorm", act="silu", tie_embeddings=True,
)
