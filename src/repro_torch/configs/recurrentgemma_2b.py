"""recurrentgemma-2b [hybrid]: 26L d2560 10H (GQA kv=1) d_ff=7680
v=256000; RG-LRU + local attention 1:2 (two recurrent blocks per local-
attention block, Griffin layout; 26 = 3*8 + 2 tail). [arXiv:2402.19427]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", d_model=2560, n_heads=10, n_kv_heads=1,
        d_ff=7680, vocab=256000, head_dim=256,
        pattern=("rec", "rec", "local"), pattern_repeats=8,
        suffix=("rec", "rec"),
        act="gelu", norm="rms", rope_theta=10000.0, window=2048,
        lru_width=2560, conv_width=4,
        source="arXiv:2402.19427")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke", d_model=256, n_heads=2,
        n_kv_heads=1, d_ff=512, vocab=512, head_dim=128,
        pattern=("rec", "rec", "local"), pattern_repeats=1,
        suffix=("rec",),
        act="gelu", norm="rms", rope_theta=10000.0, window=64,
        lru_width=256, conv_width=4)
