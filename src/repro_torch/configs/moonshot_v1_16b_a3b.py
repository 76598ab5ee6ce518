"""moonshot-v1-16b-a3b [moe]: 48L d2048 16H (kv=16) expert d_ff=1408
v=163840, MoE 64 experts top-6, first layer dense (Moonlight/DeepSeek
layout: dense d_ff = 8x expert width = 11264).
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=11264, vocab=163840, head_dim=128,
        prefix=("dense",), pattern=("moe",), pattern_repeats=47,
        act="swiglu", norm="rms", rope_theta=50000.0,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408),
        source="hf:moonshotai/Moonlight-16B-A3B")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab=512, head_dim=64,
        prefix=("dense",), pattern=("moe",), pattern_repeats=1,
        act="swiglu", norm="rms", rope_theta=50000.0,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128))
