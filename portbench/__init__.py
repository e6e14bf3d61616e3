"""The PyTorch port's benchmark: ``python3 portbench/run.py --help``."""
