"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H (GQA kv=8) d_ff=8192
v=202048, MoE 128 experts top-1, alternating dense/MoE layers (the text
path of the early-fusion decoder), qk-norm, RoPE theta 5e5.
[hf:meta-llama/Llama-4-Scout-17B-16E family, Maverick scale]"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
        pattern=("dense", "moe"), pattern_repeats=24,
        act="swiglu", norm="rms", qk_norm=True, rope_theta=500000.0,
        moe=MoEConfig(n_experts=128, top_k=1, d_ff=8192),
        source="hf:meta-llama/Llama-4-Scout-17B-16E")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=512, head_dim=64,
        pattern=("dense", "moe"), pattern_repeats=1,
        act="swiglu", norm="rms", qk_norm=True, rope_theta=500000.0,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff=512))
