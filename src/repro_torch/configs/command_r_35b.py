"""command-r-35b [dense]: 40L d8192 64H (GQA kv=8) d_ff=22528 v=256000;
GQA, no-bias projections, LayerNorm. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22528, vocab=256000, head_dim=128,
        pattern=("dense",), pattern_repeats=40,
        act="swiglu", norm="ln", use_bias=False, rope_theta=8e6,
        source="hf:CohereForAI/c4ai-command-r-v01")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b-smoke", d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=32,
        pattern=("dense",), pattern_repeats=2,
        act="swiglu", norm="ln", use_bias=False, rope_theta=8e6)
