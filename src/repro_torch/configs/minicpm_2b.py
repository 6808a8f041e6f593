"""minicpm-2b [dense]: 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753 — llama-like, no QKV bias, tied embeddings.
[arXiv:2404.06395; hf]

MiniCPM's ``scale_emb`` and ``scale_depth`` are not modelled (the JAX
package's config has neither)."""

from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122_753,
    qkv_bias=False, norm="rmsnorm", act="silu",
    rope_theta=10_000.0, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="minicpm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=8,
    d_ff=160, vocab=509,  # deliberately odd vocab
    qkv_bias=False, norm="rmsnorm", act="silu", tie_embeddings=True,
)
