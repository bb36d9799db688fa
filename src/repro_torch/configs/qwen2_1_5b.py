"""qwen2-1.5b [arXiv:2407.10671; hf]: 28L d_model=1536 12H (GQA kv=2)
d_ff=8960 vocab=151936 — GQA, QKV bias, tied embeddings, SwiGLU."""
from ..models.transformer import TransformerConfig
from .lm_shapes import LM_SHAPES

FAMILY = "lm"
SHAPES = LM_SHAPES


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, d_ff=8960, vocab=151936, mlp="swiglu", norm="rmsnorm",
        qkv_bias=True, tie_embeddings=True, rope_theta=1000000.0)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, mlp="swiglu", qkv_bias=True,
        tie_embeddings=True)
