"""DSP and match ops of the PyTorch port: plain torch plus hand-written kernels."""
