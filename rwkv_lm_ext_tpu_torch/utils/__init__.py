"""utils of the PyTorch port (see the module docstrings for each JAX counterpart)."""
