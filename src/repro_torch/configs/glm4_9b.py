"""glm4-9b [dense]: 40L d4096 32H (GQA kv=2) d_ff=13696 v=151552;
RoPE, GQA. [hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=151552, head_dim=128,
        pattern=("dense",), pattern_repeats=40,
        act="swiglu", norm="rms", rope_theta=10000.0,
        source="hf:THUDM/glm-4-9b")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke", d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=512, head_dim=64,
        pattern=("dense",), pattern_repeats=2,
        act="swiglu", norm="rms", rope_theta=10000.0)
