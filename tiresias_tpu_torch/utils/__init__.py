"""Host utilities of the PyTorch port: device resolution, tracing, kernel build."""
