"""Launch helpers of the PyTorch port: the device mesh."""
