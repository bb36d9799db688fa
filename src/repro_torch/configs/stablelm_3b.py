"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b family; unverified]: 32L
d_model=2560 32H (kv=32, MHA) d_ff=6912 vocab=50304 — LayerNorm, SwiGLU."""
from ..models.transformer import TransformerConfig
from .lm_shapes import LM_SHAPES

FAMILY = "lm"
SHAPES = LM_SHAPES


def config() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-3b", n_layers=32, d_model=2560, n_heads=32,
        n_kv_heads=32, d_ff=6912, vocab=50304, mlp="swiglu",
        norm="layernorm", qkv_bias=False)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="stablelm-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512, mlp="swiglu", norm="layernorm")
