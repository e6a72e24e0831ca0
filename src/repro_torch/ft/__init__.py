"""Fault tolerance of the PyTorch port: checkpoints (``checkpoint``, the
format of ``repro.ft.checkpoint``) and a copy of ``repro.ft.straggler``."""
