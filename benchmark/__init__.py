"""The benchmark of the PyTorch/CUDA port (``dartray_tpu_torch``): see
``run.py``."""
