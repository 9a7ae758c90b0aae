"""Tensor ops and hand-written CUDA kernels of the PyTorch port."""
