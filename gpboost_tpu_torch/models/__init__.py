"""GP model engines and estimation of the PyTorch port."""
