"""Data helpers of the PyTorch port (a copy of the byte tokenizer)."""
