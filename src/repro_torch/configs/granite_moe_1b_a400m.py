"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]: 24L
d_model=1024 16H (GQA kv=8) d_ff=512/expert, vocab=49155, MoE 32e top-8."""
from ..models.transformer import TransformerConfig
from .lm_shapes import LM_SHAPES

FAMILY = "lm"
SHAPES = LM_SHAPES


def config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, d_ff=512, vocab=49155, n_experts=32, top_k=8,
        mlp="swiglu", norm="rmsnorm", tie_embeddings=True)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="granite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=512, n_experts=4, top_k=2, mlp="swiglu",
        tie_embeddings=True)
