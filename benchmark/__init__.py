"""The benchmark of the PyTorch and CUDA port of UFM (``ufm_torch``): ``python benchmark/run.py --help``."""
