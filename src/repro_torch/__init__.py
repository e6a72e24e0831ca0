"""PyTorch/CUDA port of the DistFlow reproduction (``repro``), for one NVIDIA
H100. The JAX package stays the reference; this package imports nothing of it.

Ported so far: the serving paths (the streaming engine in ``serving``, the
lockstep ``rl.rollout.generate`` behind ``launch.serve --lockstep``) of the
dense decoder, the Mamba2 (SSD) family and the int8 KV cache, and the
training half of an RL iteration (``models.lm``'s ``full`` mode, ``optim``,
``rl``), with seven kernels hand-written in CUDA for sm_90a
(``kernels/csrc``).
"""
