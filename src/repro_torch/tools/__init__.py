"""Measurement tools of the PyTorch port that run only on a GPU."""
