"""Attention, cache and rotary operations; CUDA kernels with plain versions."""
