"""The distributed layer of the PyTorch port: the version store of the async
pipeline (``weight_sync``), and the data-parallel fleet: its file-plane
runtime and gradient exchange (``fleet``) and the exchange's int8 wire form
(``compression``); the rank mesh's sharding layer (``sharding``,
``collectives``, ``constraint``) and the train -> serve reshard
(``weight_sync.switch``)."""
from repro_torch.distributed import compression, fleet
from repro_torch.distributed.weight_sync import VersionedWeights, WeightVersionStore

__all__ = ["VersionedWeights", "WeightVersionStore", "compression", "fleet"]
