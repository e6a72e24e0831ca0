"""Entry points of the PyTorch port."""
