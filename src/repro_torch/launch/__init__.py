"""Launch helpers of the PyTorch port: the device mesh, the training
entry point (``python -m repro_torch.launch.train``) and the dry run on
the ``meta`` device (``launch.dryrun``, ``launch.roofline_pass``, on the
H100's peaks from ``launch.analysis``)."""
