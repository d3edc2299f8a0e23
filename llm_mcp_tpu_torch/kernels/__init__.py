"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

The libraries are built at first launch (`build.py`), never at import, so
this package imports on a machine without CUDA.
"""
