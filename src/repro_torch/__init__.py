"""PyTorch/CUDA port of the DistFlow reproduction (``repro``), for one NVIDIA
H100. The JAX package stays the reference; this package imports nothing of it.

Ported so far: the serving paths (the streaming engine in ``serving``, the
lockstep ``rl.rollout.generate`` behind ``launch.serve --lockstep``) of the
dense decoder, the Mamba2 (SSD) family and the int8 KV cache; the training
half of an RL iteration (``models.lm``'s ``full`` mode, ``optim``, ``rl``);
and the single-device control and data plane that drives it (``core``: the
DAG planner, registry, databuffer, stages, worker and pipeline; ``data``: the
dataset and the dataloader; ``api.ExperimentSpec``; ``launch.train``), with
seven kernels hand-written in CUDA for sm_90a (``kernels/csrc``).

The top-level entry point is :class:`repro_torch.api.ExperimentSpec`
(re-exported here lazily so ``import repro_torch`` stays cheap).
"""


def __getattr__(name):
    if name == "ExperimentSpec":
        from repro_torch.api import ExperimentSpec

        return ExperimentSpec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
