"""PyTorch/CUDA port of the FlashCommunication V2 reproduction.

The JAX package ``repro`` is the reference; this package imports none of
it. Hand-written CUDA kernels for Hopper live in ``kernels/`` with a plain
PyTorch version beside each.
"""
