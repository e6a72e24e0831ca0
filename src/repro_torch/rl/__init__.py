"""Rollout (generation) of the PyTorch port."""
