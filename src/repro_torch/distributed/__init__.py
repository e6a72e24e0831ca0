"""Weight publication of the PyTorch port: the version store of the async
pipeline (``weight_sync``). The multi-host fleet and the train -> serve
reshard are ROADMAP queue 1, item 8."""
from repro_torch.distributed.weight_sync import VersionedWeights, WeightVersionStore

__all__ = ["VersionedWeights", "WeightVersionStore"]
