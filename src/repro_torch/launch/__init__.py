"""Launch helpers of the PyTorch port: the device mesh and the training
entry point (``python -m repro_torch.launch.train``)."""
