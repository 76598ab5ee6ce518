"""whisper-tiny [audio]: 4L dec (+4L enc) d384 6H (kv=6) d_ff=1536
v=51865; enc-dec, conv frontend STUB (input_specs feeds precomputed
frame embeddings). [arXiv:2212.04356]"""
from repro_torch.models.config import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab=51865, head_dim=64,
        pattern=("dec",), pattern_repeats=4,
        act="gelu", norm="ln", use_bias=True,
        rope_theta=None, learned_pos=True, max_pos=32768,
        encoder=EncoderConfig(n_layers=4, n_ctx=1500),
        source="arXiv:2212.04356")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-smoke", d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=256, vocab=512, head_dim=64,
        pattern=("dec",), pattern_repeats=2,
        act="gelu", norm="ln", use_bias=True,
        rope_theta=None, learned_pos=True, max_pos=512,
        encoder=EncoderConfig(n_layers=2, n_ctx=64))
