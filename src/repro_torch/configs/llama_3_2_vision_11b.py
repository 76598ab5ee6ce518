"""llama-3.2-vision-11b [vlm]: 40L d4096 32H (GQA kv=8) d_ff=14336
v=128256; cross-attention image layers every 5th layer; ViT/projector is
a STUB — input_specs feeds projected patch embeddings (B, 1600, d).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.models.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=128256, head_dim=128,
        pattern=("xattn", "dense", "dense", "dense", "dense"),
        pattern_repeats=8,
        act="swiglu", norm="rms", rope_theta=500000.0,
        encoder=EncoderConfig(n_layers=0, n_ctx=1600),
        source="hf:meta-llama/Llama-3.2-11B-Vision")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-smoke", d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab=512, head_dim=64,
        pattern=("xattn", "dense"), pattern_repeats=1,
        act="swiglu", norm="rms", rope_theta=500000.0,
        encoder=EncoderConfig(n_layers=0, n_ctx=32))
