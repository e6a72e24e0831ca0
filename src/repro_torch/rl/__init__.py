"""RL of the PyTorch port: rollout (generation), rewards, advantages, losses,
the algorithm registry and the actor / critic update steps."""
from repro_torch.rl.algorithms import (
    AlgorithmSpec,
    get_algorithm,
    list_algorithms,
    register_algorithm,
)
from repro_torch.rl.trainer import RLConfig, TrainState, init_state

__all__ = ["AlgorithmSpec", "RLConfig", "TrainState", "get_algorithm", "init_state",
           "list_algorithms", "register_algorithm"]
