"""Top-level declarative API: :class:`ExperimentSpec`, the port of
``repro.api``.

An ExperimentSpec is the single serializable description of an RL
post-training run: model architecture, algorithm + hyperparameters, data
coordinator flags, async-pipeline flags, mesh, and (optionally) a custom DAG
in its JSON-dict form. ``compile()`` turns it into a runnable
:class:`~repro_torch.core.pipeline.Pipeline`; ``to_dict``/``from_dict`` (and
the JSON string forms) round-trip losslessly, and the dict has the JAX
package's schema, so a spec written by either package loads in the other.

    from repro_torch.api import ExperimentSpec
    from repro_torch.configs import get_config, reduced
    from repro_torch.rl import RLConfig

    exp = ExperimentSpec(
        model=reduced(get_config("gemma-2b"), vocab_size=260),
        rl=RLConfig(algorithm="rloo", group_size=4),
        prompts_per_iter=8,
    )
    pipe = exp.compile(device="cpu")
    pipe.run(10)
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import (
    AsyncPipelineConfig,
    DataCoordinatorConfig,
    DistributedConfig,
    EnvConfig,
    ModelConfig,
    ObsConfig,
    RolloutEngineConfig,
)
from repro_torch.rl.trainer import RLConfig


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Declarative description of one RL experiment.

    ``dag`` is the DAG's dict form (``DAG.to_spec()`` / the JSON config
    schema), not a live DAG object, so the spec stays JSON-serializable;
    ``None`` means "use the algorithm's built-in template".
    ``mesh_shape=None`` (or a shape of one device) compiles onto one device;
    a larger shape onto a rank mesh of the running ``torch.distributed``
    world.
    """

    model: ModelConfig
    rl: RLConfig = dataclasses.field(default_factory=RLConfig)
    coordinator: DataCoordinatorConfig = dataclasses.field(
        default_factory=DataCoordinatorConfig
    )
    async_pipeline: AsyncPipelineConfig = dataclasses.field(
        default_factory=AsyncPipelineConfig
    )
    rollout: RolloutEngineConfig = dataclasses.field(
        default_factory=RolloutEngineConfig
    )
    env: EnvConfig = dataclasses.field(default_factory=EnvConfig)
    # multi-host fleet; None = single-host, the default
    distributed: Optional[DistributedConfig] = None
    # telemetry; disabled by default
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ("data", "model")
    prompts_per_iter: int = 8
    centralized: bool = False
    seed: int = 0
    dag: Optional[Dict] = None

    # ------------------------------------------------------------------ #
    @property
    def algorithm(self):
        """The resolved :class:`~repro_torch.rl.algorithms.AlgorithmSpec`."""
        from repro_torch.rl import algorithms

        return algorithms.get_algorithm(self.rl.algorithm)

    # ------------------------------------------------------------------ #
    # serialization
    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        return {
            "model": dataclasses.asdict(self.model),
            "rl": dataclasses.asdict(self.rl),
            "coordinator": dataclasses.asdict(self.coordinator),
            "async_pipeline": dataclasses.asdict(self.async_pipeline),
            "rollout": dataclasses.asdict(self.rollout),
            "env": dataclasses.asdict(self.env),
            "distributed": (
                dataclasses.asdict(self.distributed)
                if self.distributed is not None else None
            ),
            "obs": dataclasses.asdict(self.obs),
            "mesh_shape": list(self.mesh_shape) if self.mesh_shape else None,
            "mesh_axes": list(self.mesh_axes),
            "prompts_per_iter": self.prompts_per_iter,
            "centralized": self.centralized,
            "seed": self.seed,
            "dag": self.dag,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        mesh_shape = d.get("mesh_shape")
        return cls(
            model=ModelConfig(**d["model"]),
            rl=RLConfig(**d.get("rl", {})),
            coordinator=DataCoordinatorConfig(**d.get("coordinator", {})),
            async_pipeline=AsyncPipelineConfig(**d.get("async_pipeline", {})),
            rollout=RolloutEngineConfig(**d.get("rollout", {})),
            env=EnvConfig(**d.get("env", {})),
            distributed=(
                DistributedConfig(**d["distributed"])
                if d.get("distributed") else None
            ),
            obs=ObsConfig(**d.get("obs", {})),
            mesh_shape=tuple(mesh_shape) if mesh_shape else None,
            mesh_axes=tuple(d.get("mesh_axes", ("data", "model"))),
            prompts_per_iter=d.get("prompts_per_iter", 8),
            centralized=d.get("centralized", False),
            seed=d.get("seed", 0),
            dag=d.get("dag"),
        )

    def to_json(self, *, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------------ #
    # compilation
    # ------------------------------------------------------------------ #
    def compile(self, *, device="cuda", mesh=None, dataset=None, registry=None):
        """Compile the spec into a runnable Pipeline on ``device`` (``cuda``
        unless the CPU is asked for; without CUDA it raises).

        ``mesh`` overrides ``mesh_shape`` (useful when the caller already
        holds a rank mesh). A ``mesh_shape`` of more than one device is a
        rank mesh over the running ``torch.distributed`` world
        (``launch.mesh.init_distributed``), one process a device;
        ``dataset``/``registry`` are the non-serializable escape hatches for
        custom data sources and stage functions.
        """
        from repro_torch.core.dag import DAG
        from repro_torch.core.pipeline import build_pipeline

        mesh_shape = None
        if mesh is None and self.mesh_shape is not None:
            mesh_shape = dict(zip(self.mesh_axes, self.mesh_shape))
        dag = DAG.from_spec(self.dag) if self.dag is not None else None
        return build_pipeline(
            self.model,
            self.rl,
            device=device,
            mesh=mesh,
            mesh_shape=mesh_shape,
            dag=dag,
            dataset=dataset,
            prompts_per_iter=self.prompts_per_iter,
            centralized=self.centralized,
            coordinator=self.coordinator,
            async_pipeline=self.async_pipeline,
            rollout=self.rollout,
            env=self.env,
            distributed=self.distributed,
            obs=self.obs,
            registry=registry,
            algorithm=self.algorithm,
            seed=self.seed,
        )
