"""PyTorch/CUDA port of the DistFlow reproduction (``repro``), for one NVIDIA
H100. The JAX package stays the reference; this package imports nothing of it.

This slice ports the lockstep serving path: the dense decoder (gemma-2b),
``rl.rollout.generate`` and ``launch.serve --lockstep``, with four kernels
hand-written in CUDA for sm_90a (``kernels/csrc``).
"""
