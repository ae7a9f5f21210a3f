"""CUDA launch wrappers, their plain PyTorch versions and dispatch."""
