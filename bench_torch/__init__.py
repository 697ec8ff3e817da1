"""The benchmark of the PyTorch and CUDA port (``openmcmc_tpu_torch``): see ``run.py``."""
