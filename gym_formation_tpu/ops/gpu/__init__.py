"""Pallas kernels compiled for NVIDIA GPUs (through Triton)."""
