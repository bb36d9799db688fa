"""olmoe-1b-7b [arXiv:2409.02060; hf]: 16L d_model=2048 16H (kv=16)
d_ff=1024/expert, vocab=50304, MoE 64 experts top-8."""
from ..models.transformer import TransformerConfig
from .lm_shapes import LM_SHAPES

FAMILY = "lm"
SHAPES = LM_SHAPES


def config() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1024, vocab=50304, n_experts=64, top_k=8,
        mlp="swiglu", norm="rmsnorm", qkv_bias=False)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=512, n_experts=8, top_k=2, mlp="swiglu")
