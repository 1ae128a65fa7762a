"""utils of the PyTorch port (see the module docstrings for each JAX counterpart)."""
from rwkv_lm_ext_tpu_torch.utils.profiling import (  # noqa: F401
    Throughput,
    profile_trace,
    record_time,
)
