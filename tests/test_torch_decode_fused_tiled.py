"""The factorings of the redesigned fused decode kernels, in plain PyTorch on
the CPU, against the JAX package and the port's plain versions.

``att_prep_sliced_plain`` is B.10's cluster body (csrc/decode_fused.cu): rows
in groups padded by repeating the last row, C in column slices, the row sums,
the partial xxx @ w1 and the partial xw @ dw1 taken slice by slice and added
in slice order, each slice's expansions over its own columns.
``ffn_block_split_plain`` is B.12's bf16 products: the value product in
slices of F, each an fp32 partial, added in slice order.

Same numpy-seeded inputs on every side. Cases: B = 1, 6, 16 (16 reaches the
Pallas kernels in interpret mode; 6 and 1 are rows the TPU wrappers hand to
their jnp compositions), 2, 4 and 8 slices, fp32 and bf16 activations.
Tolerances as tests/test_torch_decode_fused.py: the prologue 2e-5 in fp32,
the channel-mix block 3e-5, bf16 atol=1e-4 / rtol=1e-2 (one ulp at rounding
ties).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.ops import decode_fused as jdf
from rwkv_lm_ext_tpu_torch.ops.decode_fused import (
    att_prep_cluster_rows,
    att_prep_plain,
    att_prep_sliced_plain,
    b10_body,
    ffn_block_plain,
    ffn_block_split_plain,
    ffn_value_splits,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

EPS = 1e-5
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=1e-4, rtol=1e-2)}
BLOCK_TOL = {"float32": dict(atol=3e-5, rtol=3e-5), "bfloat16": dict(atol=1e-4, rtol=1e-2)}
NAMES = ("xr", "xk", "xv", "xg", "w", "xn")


def _mk(rng, *shape, s=1.0):
    return (rng.normal(size=shape) * s).astype(np.float32)


def _att_inputs(B, C=256, D=8, Dd=16):
    rng = np.random.default_rng(100 + B)
    return [_mk(rng, B, C), _mk(rng, B, C), 1.0 + 0.1 * _mk(rng, C), 0.1 * _mk(rng, C),
            _mk(rng, 6, C, s=0.5), _mk(rng, C, 5 * D, s=0.2), _mk(rng, 5, D, C, s=0.2),
            _mk(rng, C, Dd, s=0.2), _mk(rng, Dd, C, s=0.2), _mk(rng, C)]


def _ffn_inputs(B, C=512, F=1024):
    """JAX layout (in, out) for the three weights; the port takes them
    transposed."""
    rng = np.random.default_rng(200 + B)
    return [_mk(rng, B, C), _mk(rng, B, C), 1.0 + 0.1 * _mk(rng, C), 0.1 * _mk(rng, C),
            rng.uniform(size=C).astype(np.float32), rng.uniform(size=C).astype(np.float32),
            _mk(rng, C, F, s=0.05), _mk(rng, F, C, s=0.05), _mk(rng, C, C, s=0.05)]


def _torch(args, dtype, transpose=(), cast=()):
    out = [torch.from_numpy(a.T.copy() if i in transpose else a) for i, a in enumerate(args)]
    for i in (0,) + tuple(cast):
        out[i] = out[i].to(getattr(torch, dtype))
    return out


def _jax(args, dtype, cast=()):
    out = [jnp.asarray(a) for a in args]
    for i in (0,) + tuple(cast):
        out[i] = out[i].astype(dtype)
    return out


@functools.lru_cache(maxsize=None)
def _att_refs(B, dtype):
    """(inputs, JAX composition, Pallas kernel in interpret mode, port plain)."""
    args = _att_inputs(B)
    jargs = _jax(args, dtype)
    refs = (jdf._att_prep_ref(*jargs, EPS), jdf.att_prep_fused(*jargs, EPS, interpret=True))
    refs = tuple(tuple(np.asarray(r.astype(jnp.float32)) for r in ref) for ref in refs)
    plain = att_prep_plain(*_torch(args, dtype), EPS)
    return args, refs, plain


@functools.lru_cache(maxsize=None)
def _ffn_refs(B, dtype):
    args = _ffn_inputs(B)
    jargs = _jax(args, dtype, cast=(6, 7, 8))
    refs = (jdf._ffn_block_ref(*jargs, EPS), jdf.ffn_block_fused(*jargs, EPS, interpret=True))
    refs = tuple(tuple(np.asarray(r.astype(jnp.float32)) for r in ref) for ref in refs)
    targs = _torch(args, dtype, transpose=(6, 7, 8), cast=(6, 7, 8))
    return targs, refs, ffn_block_plain(*targs, EPS)


def _close(got, want, tol, names):
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        w = np.asarray(w.float().numpy() if isinstance(w, torch.Tensor) else w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slices", [2, 4, 8])
@pytest.mark.parametrize("B", [1, 6, 16])
def test_att_prep_sliced_matches_jax_and_plain(B, slices, dtype):
    args, (ref, pallas), plain = _att_refs(B, dtype)
    got = att_prep_sliced_plain(*_torch(args, dtype), EPS, slices=slices)
    assert [g.dtype for g in got] == [getattr(torch, dtype)] * 4 + [torch.float32] * 2
    _close(got, ref, TOL[dtype], NAMES)
    _close(got, pallas, TOL[dtype], NAMES)
    _close(got, plain, TOL[dtype], NAMES)


@pytest.mark.parametrize("rows", [1, 4, 5, 8])
def test_att_prep_sliced_row_groups_pad_with_the_last_row(rows):
    """B=6 in groups of 4, 5 or 8 rows leaves a last group padded by the last
    row; the outputs of the padding are dropped and the rows unchanged."""
    args, (ref, _), plain = _att_refs(6, "float32")
    got = att_prep_sliced_plain(*_torch(args, "float32"), EPS, slices=8, rows=rows)
    _close(got, ref, TOL["float32"], NAMES)
    _close(got, plain, TOL["float32"], NAMES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 3, 4])
@pytest.mark.parametrize("B", [1, 6, 16])
def test_ffn_block_split_matches_jax_and_plain(B, splits, dtype):
    targs, (ref, pallas), plain = _ffn_refs(B, dtype)
    got = ffn_block_split_plain(*targs, EPS, splits=splits)
    assert got[0].dtype == getattr(torch, dtype) and got[1].dtype == torch.float32
    _close(got, ref, BLOCK_TOL[dtype], ("out", "xn"))
    _close(got, pallas, BLOCK_TOL[dtype], ("out", "xn"))
    _close(got, plain, BLOCK_TOL[dtype], ("out", "xn"))


def test_body_rows_and_splits_rules():
    """B.10's cluster body takes bf16 at every served width (0.1B, 1B6, 3B,
    7B and the test width 256) and leaves fp32 to the row-pair body; the
    rows a cluster takes make one wave of the clusters the card runs at
    once; B.12's value slices fill 132 SMs with the receptance blocks."""
    bf, f32 = torch.bfloat16, torch.float32
    for C, D, Dd in [(768, 32, 64), (2048, 32, 64), (2560, 32, 64), (4096, 64, 128), (256, 8, 16)]:
        assert b10_body(bf, C, D, Dd) == "cluster"
        assert b10_body(f32, C, D, Dd, f32) == "row_pairs"
    assert b10_body(bf, 64, 8, 8) == "row_pairs"          # C/8 not a multiple of 16
    assert b10_body(bf, 8192, 32, 64) == "row_pairs"      # C/8 above 512
    assert b10_body(bf, 2048, 96, 64) == "row_pairs"      # 5D above 384
    assert b10_body(bf, 2048, 32, 24) == "row_pairs"      # Dd not a multiple of 16
    assert b10_body(bf, 2048, 32, 64, f32) == "row_pairs"  # fp32 parameters
    assert [att_prep_cluster_rows(b) for b in (1, 8, 9, 64, 65, 1000)] == [1, 1, 2, 8, 8, 8]
    assert [att_prep_cluster_rows(b, 16) for b in (1, 16, 17, 64, 128, 130)] == [1, 1, 2, 4, 8, 8]
    assert ffn_value_splits(2048, 7168, 132) == 3          # 32 x 3 value + 32 receptance blocks
    assert ffn_value_splits(4096, 14336, 132) == 1
    assert ffn_value_splits(768, 2688, 132) == 4           # at most four
    assert ffn_value_splits(96, 32, 132) == 1              # no more slices than stages of F
