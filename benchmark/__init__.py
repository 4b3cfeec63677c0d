"""The benchmark of the PyTorch and CUDA port: one cell, one run (``run.py``)."""
