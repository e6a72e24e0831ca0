"""Data of the PyTorch port: copies of the byte tokenizer and the datasets,
and the Distributed Dataloader on one device."""
from repro_torch.data.dataloader import DistributedDataloader
from repro_torch.data.dataset import SyntheticMathDataset, SyntheticTextDataset
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "DistributedDataloader", "SyntheticMathDataset",
           "SyntheticTextDataset"]
