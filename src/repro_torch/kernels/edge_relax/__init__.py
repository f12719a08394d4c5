"""Fused Δ-growing edge relaxation: CUDA kernel, plain version, wrapper."""
