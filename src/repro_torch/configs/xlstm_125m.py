"""xlstm-125m [ssm]: 12L d768 4H d_ff=0 v=50304; alternating
mLSTM / sLSTM blocks (no separate FFN; no positional encoding —
recurrence carries order). [arXiv:2405.04517]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        pattern=("mlstm", "slstm"), pattern_repeats=6,
        act="gelu", norm="ln", use_bias=False,
        rope_theta=None, learned_pos=False,
        source="arXiv:2405.04517")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m-smoke", d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=0, vocab=512,
        pattern=("mlstm", "slstm"), pattern_repeats=1,
        act="gelu", norm="ln", use_bias=False,
        rope_theta=None, learned_pos=False)
