"""Fault tolerance of the PyTorch port: the length-aware balancer of
``repro.ft.straggler`` (the rest of that module and checkpoints are ROADMAP
queue 1, item 7)."""
