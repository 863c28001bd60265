"""The benchmark of the PyTorch and CUDA port (``multiclust_tpu_torch``);
``python3 benchmark/run.py --help`` runs one cell (see harness.py)."""
