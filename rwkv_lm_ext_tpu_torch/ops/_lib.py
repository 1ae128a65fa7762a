"""Build, load and launch the port's CUDA kernels.

No JAX counterpart: the Pallas kernels were compiled by XLA inside jit. Here
every source under ``csrc/`` is compiled by ``nvcc`` for sm_90a, at first
use, one ``nvcc -c`` per source, all started together, and the objects are
linked into ONE shared library with a plain C interface, loaded with
ctypes. The library's file name carries a hash of the sources and flags, so
editing a source rebuilds it. It is written to
``rwkv_lm_ext_tpu_torch/build/`` (git-ignored). Importing this module
builds nothing, so the package imports on a machine without nvcc or a GPU
and runs the plain versions on the CPU. There is no fast-math flag: the
int8 quantizer (csrc/quant.cu) must stay bit-identical to its plain
version.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises on anything but ``cudaSuccess``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # x, scale, bias, y, M, C, eps, dtype, stream
    "rwkv_layer_norm": [_P, _P, _P, _P, _L, _I, _F, _I, _P],
    # x, shift, ln_scale, ln_bias, maa, w1, w2, out, B, T, C, D, eps, dtype, body, stream
    "rwkv_tmix_prologue": [_P] * 8 + [_I] * 4 + [_F, _I, _I, _P],
    # r, k, v, w, u, g, scale, bias, s0, out, sT, B, T, H, N, eps, dtype, body, stream
    "rwkv_wkv6_fused": [_P] * 11 + [_I] * 4 + [_F, _I, _I, _P],
    # x, q, s, M, C, dtype, stream
    "rwkv_quantize_rows": [_P] * 3 + [_L, _I, _I, _P],
    # x, q, s (given), M, C, dtype, stream
    "rwkv_quantize_rows_given": [_P] * 3 + [_L, _I, _I, _P],
    # r, k, v, w, u, g, scale, bias, state, out, out_state, B, H, N, eps, dtype,
    # param dtype, stream
    "rwkv_wkv6_decode": [_P] * 11 + [_I] * 3 + [_F, _I, _I, _P],
    # r, k, v, w, u, g, scale, bias, s0, dout, dsT, dy, drp, dg, dsc_p, dbi_p,
    # cT, B, T, H, N, eps, dtype, stream
    "rwkv_wkv6_bwd_forward": [_P] * 17 + [_I] * 4 + [_F, _I, _P],
    # r, k, v, w, u, dy, drp, cT, dsT, lengths, dr, dk, dv, dw, du_p, ds0, B, T,
    # H, N, reverse, dtype, stream
    "rwkv_wkv6_bwd_reverse": [_P] * 16 + [_I] * 6 + [_P],
    # r, k, v, w, u, s0, lengths, y, sT, B, T, H, N, reverse, dtype, body, stream
    "rwkv_wkv6": [_P] * 9 + [_I] * 7 + [_P],
    # k, v, w, s0, dy, dsT, lengths, drp, cT, B, T, H, N, reverse, dtype, stream
    "rwkv_wkv6_bwd_state": [_P] * 9 + [_I] * 6 + [_P],
    # x, shift, ln_scale, ln_bias, maa, w1, w1T, w2, w2T, d0..d4, dxln, dx,
    # dshift, dw1, dw2, 8 scratch buffers, B, T, C, D, eps, dtype, body, stream
    "rwkv_tmix_prologue_bwd": [_P] * 27 + [_I] * 4 + [_F, _I, _I, _P],
    # r, k, v, w, u, g, scale, bias, s0, dout, states, dy, dg, dsc_p, dbi_p, B, T,
    # H, N, eps, stream
    "rwkv_wkv6_bwd_forward_chunked": [_P] * 15 + [_I] * 4 + [_F, _P],
    # k, v, w, s0, lengths, states, B, T, H, N, reverse, stream
    "rwkv_wkv6_bwd_state_chunked": [_P] * 6 + [_I] * 5 + [_P],
    # r, k, v, w, u, dy, states, dsT, lengths, dr, dk, dv, dw, du_p, ds0, B, T, H,
    # N, reverse, stream
    "rwkv_wkv6_bwd_reverse_chunked": [_P] * 15 + [_I] * 5 + [_P],
    # in, out, P, M, stream
    "rwkv_sum_partials": [_P, _P, _I, _L, _P],
    # B.9's arguments, the state and out_state transposed, and the grid before
    # the stream
    "rwkv_wkv6_decode_transposed": [_P] * 11 + [_I] * 3 + [_F, _I, _I, _I, _P],
    # x, shift, ln_scale, ln_bias, maas, w1, w2, dw1, dw2, time_decay, xr, xk, xv,
    # xg, w, xn, B, C, D, Dd, eps, dtype, param dtype, stream
    "rwkv_att_prep": [_P] * 16 + [_I] * 4 + [_F, _I, _I, _P],
    # rwkv_att_prep's arguments and the body code before the stream
    "rwkv_att_prep_body": [_P] * 16 + [_I] * 4 + [_F, _I, _I, _I, _P],
    # x, shift, ln_scale, ln_bias, maa_k, maa_r, xk, xr, xn, B, C, eps, dtype,
    # param dtype, stream
    "rwkv_ffn_prep": [_P] * 9 + [_I] * 2 + [_F, _I, _I, _P],
    # x, shift, ln_scale, ln_bias, maa_k, maa_r, wk, wv, wr, out, xn, and the
    # scratch xk, xr, k, partials, B, C, F, eps, dtype, param dtype, stream
    "rwkv_ffn_block": [_P] * 15 + [_I] * 3 + [_F, _I, _I, _P],
    # r, k, v, w, u, g, scale, bias, s0, out, states, t_stride, B, T, H, N, eps,
    # dtype, stream
    "rwkv_wkv6_collect": [_P] * 11 + [_L] + [_I] * 4 + [_F, _I, _P],
    # k, v, w, u, aa, bb, pp, y, aa_out, bb_out, pp_out, ck, B, T, C, dtype, stream
    "rwkv_wkv4": [_P] * 12 + [_I] * 4 + [_P],
    # k, v, w, u, ck, gy, gaa_T, gbb_T, gpp_T, gk, gv, gw_p, gu_p, gaa0, gbb0, gpp0,
    # B, T, C, dtype, stream
    "rwkv_wkv4_bwd": [_P] * 16 + [_I] * 4 + [_P],
}
# entry points that return a size, not an error code
_SIZE_FUNCTIONS = {
    "rwkv_tmix_prologue_smem_bytes": [_I, _I, _I],
    "rwkv_wkv6_fused_chunk": [],
    "rwkv_wkv6_fused_blocks_per_sm": [_I],
    "rwkv_tmix_prologue_bwd_smem_bytes": [_I, _I, _I],
    "rwkv_att_prep_smem_bytes": [_I, _I, _I],
    "rwkv_ffn_block_slices": [_I],
    "rwkv_ffn_value_splits": [_I, _I, _I],
    "rwkv_wkv6_decode_stream_blocks_per_sm": [_I, _I, _I],
}

_load_lock = threading.Lock()
_library = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
        "the CUDA kernels of rwkv_lm_ext_tpu_torch cannot be built"
    )


def build(extra_flags: Sequence[str] = ()) -> tuple[Path, str]:
    """Compile csrc/*.cu into the build directory unless a library of the
    same sources and flags is already there. Returns (library path, nvcc's
    stderr, empty when nothing was compiled). Raises with nvcc's stderr if
    the build fails."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for f in sources + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    flags = NVCC_FLAGS + tuple(extra_flags)
    digest.update(" ".join(flags).encode())
    tag = digest.hexdigest()[:16]
    out = BUILD_DIR / f"librwkv_kernels_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{f.stem}_{tag}.{os.getpid()}.o" for f in sources]
    # one compiler per source, all running at once; then one link
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in ([nvcc, *flags, "-c", "-o", str(o), str(f)] for f, o in zip(sources, objs))
    ]
    logs = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
                other.wait()
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{err}"
            )
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *flags, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, "".join(logs) + proc.stderr


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded on first call."""
    global _library
    with _load_lock:
        if _library is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rwkv_error_string.argtypes = [ctypes.c_int]
            lib.rwkv_error_string.restype = ctypes.c_char_p
            for name, argtypes in _SIZE_FUNCTIONS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _L
            _library = lib
        return _library


def check_cuda(**tensors: torch.Tensor) -> torch.device:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    in a dtype the kernels take; returns that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, not a CUDA device")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"{name} has dtype {t.dtype}; kernels take {list(DTYPE_CODES)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return devices.pop()


def param_vectors(*params):
    """Parameters of one call in one dtype the kernels take: as they are when
    they already share one, else fp32. Returns (tensors, dtype code)."""
    dtypes = {p.dtype for p in params}
    dtype = dtypes.pop() if len(dtypes) == 1 and dtypes <= set(DTYPE_CODES) else torch.float32
    return [p.to(dtype).contiguous() for p in params], DTYPE_CODES[dtype]


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point `name` on `device`; tensors in `args` are passed
    as device pointers (None as a null pointer), and the current stream is
    appended. Raises if the launch is refused."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        code = getattr(lib, name)(*cargs, stream)
    if code != 0:
        raise RuntimeError(
            f"{name}: CUDA error {code} ({lib.rwkv_error_string(code).decode()})"
        )


def sum_partials(partials: torch.Tensor) -> torch.Tensor:
    """(P, ...) fp32 CUDA partial sums -> their sum over the leading axis,
    added in increasing p by csrc/wkv_fused_bwd.cu's rwkv_sum_partials (no
    atomics: the same partials give the same bits). Part of the launch of
    the backward kernel whose partials it reduces; not counted on its own."""
    device = check_cuda(partials=partials)
    if partials.dtype != torch.float32:
        raise TypeError(f"partials must be fp32, not {partials.dtype}")
    out = torch.empty(partials.shape[1:], dtype=torch.float32, device=device)
    launch("rwkv_sum_partials", device, partials, out, partials.shape[0], out.numel())
    return out


def needs_grad(*tensors) -> bool:
    """True when autograd would record a call on these inputs: grad mode is
    on and one of them (None allowed) requires grad. The kernel wrappers
    take their autograd.Function, or refuse, only then; serving, under
    inference_mode, keeps the direct launch."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def recompute_backward(launch, plain, tensors, **kw):
    """``launch(*tensors, **kw)`` (a kernel) as a differentiable call whose
    backward re-runs ``plain(*tensors, **kw)`` on the saved inputs and
    differentiates that: what the JAX package's ``custom_vjp``s do for the
    kernels that have no backward kernel. Both return a tuple of tensors."""
    return _RecomputeBackward.apply(launch, plain, kw, *tensors)


class _RecomputeBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, launch, plain, kw, *tensors):
        ctx.set_materialize_grads(False)
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*tensors)
        return tuple(launch(*tensors, **kw))

    @staticmethod
    def backward(ctx, *cts):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            outs = ctx.plain(*leaves, **ctx.kw)
            pairs = [(o, ct) for o, ct in zip(outs, cts) if ct is not None and o.requires_grad]
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [ct for _, ct in pairs], allow_unused=True,
            ) if pairs else [None] * len(wanted))
        return (None, None, None) + tuple(next(grads) if n else None for n in need)


def smem_limit(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin
