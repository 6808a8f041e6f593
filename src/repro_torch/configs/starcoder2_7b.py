"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE, LayerNorm, GELU, QKV bias. [arXiv:2402.19173; hf]

As in the JAX package's config the MLP is gated (w_gate, w_up, w_down
with a GELU-GLU); the published starcoder2-7b MLP is not."""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49_152,
    qkv_bias=True, norm="layernorm", act="gelu",
    rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="starcoder2-smoke", family="dense",
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=2,
    d_ff=192, vocab=512,
    qkv_bias=True, norm="layernorm", act="gelu", tie_embeddings=True,
)
