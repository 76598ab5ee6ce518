"""Hand-written CUDA kernels and their dispatch."""
from repro_torch.kernels.ops import (  # noqa: F401
    fused_all_to_all, fused_decode_reduce, fused_decode_wire,
    fused_dequant_unpack, fused_encode_wire, fused_quant_pack,
    fused_spike_pack)
