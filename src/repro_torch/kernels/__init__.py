"""Kernels of the PyTorch port: hand-written CUDA for Hopper (``csrc/``),
their wrappers, their plain PyTorch versions (``ref``) and the dispatch
(``ops``). Nothing is built or loaded at import."""
