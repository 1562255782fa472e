"""Samplers, the text-to-image pipeline, its serving engine and CUDA
graph capture."""
