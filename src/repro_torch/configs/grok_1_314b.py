"""grok-1-314b [moe]: 64L d6144 48H (GQA kv=8) d_ff=32768 v=131072,
MoE 8 experts top-2, GeGLU experts. [hf:xai-org/grok-1]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab=131072, head_dim=128,
        pattern=("moe",), pattern_repeats=64,
        act="geglu", norm="rms", rope_theta=10000.0,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32768),
        source="hf:xai-org/grok-1")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke", d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=64,
        pattern=("moe",), pattern_repeats=2,
        act="geglu", norm="rms", rope_theta=10000.0,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=512))
