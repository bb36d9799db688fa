"""starcoder2-3b [arXiv:2402.19173; hf]: 30L d_model=3072 24H (GQA kv=2)
d_ff=12288 vocab=49152 — GQA, RoPE, LayerNorm+bias, gelu MLP."""
from ..models.transformer import TransformerConfig
from .lm_shapes import LM_SHAPES

FAMILY = "lm"
SHAPES = LM_SHAPES


def config() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24,
        n_kv_heads=2, d_ff=12288, vocab=49152, mlp="gelu", norm="layernorm",
        qkv_bias=True)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, mlp="gelu", norm="layernorm",
        qkv_bias=True)
