"""PyTorch/CUDA port of the DistFlow reproduction (``repro``), for one NVIDIA
H100. The JAX package stays the reference; this package imports nothing of it.

Ported so far: the serving paths of the dense decoder (gemma-2b). The
streaming engine (``serving``, the default of ``launch.serve``) with chunked
prefill and paged decode over a page pool, and the lockstep path
(``rl.rollout.generate`` behind ``launch.serve --lockstep``), with five
kernels hand-written in CUDA for sm_90a (``kernels/csrc``).
"""
