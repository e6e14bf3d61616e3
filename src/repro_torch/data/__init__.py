"""Synthetic datasets for the PyTorch port (numpy)."""
