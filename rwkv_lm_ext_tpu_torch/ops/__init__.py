"""Kernels of the port and their plain versions.

Each kernel's wrapper carries an integer ``launches`` attribute that it
raises by one where it launches the kernel, and nowhere else. The backward
wrappers (B.5, B.6 and its GroupNorm-free variant, B.7) count a launch each time an autograd backward, or
a direct call, runs them. The fused decode wrappers (B.10-B.12) and both decode
steps (B.9, B.13) count their forward launch; their backward is a recompute
through the plain version and launches nothing. RWKV-4's WKV (B.14) counts
its forward launch and its backward kernel (``wkv4_bwd``) each of its own.
The collecting WKV (B.15, the speculative verify pass) counts its forward
launch; it has no backward. B.4's given-scale entry (``quantize_rows_given``,
the tensor-parallel int8c projections) counts its own launches.

``wkv_chunked`` (ops/wkv_chunked.py, JAX's XLA ``chunked`` backend and the
local scan of sequence parallelism, exported here as JAX's ops package
exports it) is B.8 on CUDA tensors: it counts as ``wkv``.
"""
from rwkv_lm_ext_tpu_torch.ops.decode_fused import (
    att_prep_fused,
    ffn_block_fused,
    ffn_prep_fused,
)
from rwkv_lm_ext_tpu_torch.ops.ddlerp import tmix_prologue, tmix_prologue_bwd
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows, quantize_rows_given
from rwkv_lm_ext_tpu_torch.ops.wkv import wkv, wkv_bwd_state_pass
from rwkv_lm_ext_tpu_torch.ops.wkv4 import wkv4, wkv4_bwd
from rwkv_lm_ext_tpu_torch.ops.wkv_chunked import wkv_chunked  # noqa: F401
from rwkv_lm_ext_tpu_torch.ops.wkv_collect import wkv6_collect
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import (
    wkv6_decode_step,
    wkv6_decode_step_transposed,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    wkv6_bwd_forward_pass,
    wkv6_bwd_reverse_pass,
    wkv6_fused_output,
)

KERNEL_WRAPPERS = (
    layer_norm, tmix_prologue, wkv6_fused_output, wkv6_decode_step, quantize_rows,
    tmix_prologue_bwd, wkv6_bwd_forward_pass, wkv6_bwd_reverse_pass,
    wkv, wkv_bwd_state_pass,
    att_prep_fused, ffn_prep_fused, ffn_block_fused, wkv6_decode_step_transposed, wkv4,
    wkv4_bwd, wkv6_collect, quantize_rows_given,
)


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
