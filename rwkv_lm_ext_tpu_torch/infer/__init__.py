"""infer of the PyTorch port (see the module docstrings for each JAX counterpart)."""
from rwkv_lm_ext_tpu_torch.infer.speculative import SpeculativeEngine

__all__ = ["SpeculativeEngine"]
