"""qwen3-14b [dense]: 40L d5120 40H (GQA kv=8) d_ff=17408 v=151936;
qk_norm, GQA. [hf:Qwen/Qwen3-8B family scaled per assignment]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=17408, vocab=151936, head_dim=128,
        pattern=("dense",), pattern_repeats=40,
        act="swiglu", norm="rms", qk_norm=True, rope_theta=1e6,
        source="hf:Qwen/Qwen3-8B")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke", d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=64,
        pattern=("dense",), pattern_repeats=2,
        act="swiglu", norm="rms", qk_norm=True, rope_theta=1e6)
