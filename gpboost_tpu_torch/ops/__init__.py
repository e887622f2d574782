"""Tensor ops of the PyTorch port: distances, covariance functions, batched
Cholesky solves and the histogram kernel."""
