"""The walk of the tensor-core body of B.5 (the ddlerp prologue's backward,
csrc/ddlerp_bwd.cu), in plain PyTorch on the CPU:
``tmix_prologue_bwd_tiled_plain``. Its tiles hold 32 flattened rows b*T + t
and own the first 31, so they straddle sequences wherever T is not a
multiple of 31; the token shift's dxx[t+1] comes from the tile's next row
(the halo for the last owned row) and never from another sequence, dshift
from the tile that owns each sequence's row 0, and the column sums of dmaa
and dln tile by tile. Its product operands are rounded as the kernel stores
them (the weights as bf16, the activations as two bf16 limbs).

Same numpy-seeded inputs on every side, rounded to bf16 values (the kernel's
inputs), in fp32. Cases: B = 1 and 3, T = 1, 17, 63, 64, 65, 130, C = 64 and
128, D = 32 and 64, both forms (with and without the weight gradients), one
cotangent None (dxln, as in the model) and several (dxk, dxr, dxln).

Tolerances, x max|reference| per gradient: 5e-5 against autograd through
the fp32 plain version (``tmix_prologue_bwd_plain``) and against jax.vjp of
the Pallas prologue in interpret mode (whose backward runs in fp32): what
is left is the two-limb rounding of the four products' activation operands
(about 2^-16 each; read up to 7.8e-6 against autograd) and the order of
fp32 sums. The Pallas comparison runs at one shape per T (B, C and D
alternating), as each shape compiles anew.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.ops.ddlerp_pallas import _prologue
from rwkv_lm_ext_tpu_torch.ops.ddlerp import (
    B5_LIMBS,
    b5_body,
    k2_body,
    tmix_prologue_bwd_plain,
    tmix_prologue_bwd_tiled_plain,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

NAMES = ("dx", "dshift", "dln_scale", "dln_bias", "dmaa", "dw1", "dw2")
MISSING = {"one": (5,), "several": (1, 3, 5)}   # cotangents left None: dxln; dxk, dxr, dxln
REL = 5e-5


def _bf(a):
    return np.asarray(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float())


@functools.lru_cache(maxsize=None)
def _inputs(B, T, C, D):
    rng = np.random.default_rng(B * 1000 + T * 10 + C + D)
    args = (rng.normal(size=(B, T, C)), rng.normal(size=(B, C)), 1 + 0.1 * rng.normal(size=C),
            0.1 * rng.normal(size=C), rng.uniform(0, 1, size=(6, C)),
            0.1 * rng.normal(size=(C, 5 * D)), 0.1 * rng.normal(size=(5, D, C)))
    cts = tuple(rng.normal(size=(B, T, C)) for _ in range(6))
    return tuple(map(_bf, args)), tuple(map(_bf, cts))


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (what, err, np.abs(want).max())


def _cts(cts, missing):
    return [None if i in MISSING[missing] else torch.from_numpy(c) for i, c in enumerate(cts)]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("C", [64, 128])
@pytest.mark.parametrize("T", [1, 17, 63, 64, 65, 130])
@pytest.mark.parametrize("B", [1, 3])
def test_tiled_mirror_matches_autograd(B, T, C, D):
    args, cts = _inputs(B, T, C, D)
    targs = [torch.from_numpy(a) for a in args]
    for missing in MISSING:
        c = _cts(cts, missing)
        want = tmix_prologue_bwd_plain(*targs, c)
        got = tmix_prologue_bwd_tiled_plain(*targs, c)
        for n, g, w in zip(NAMES, got, want):
            assert g.shape == w.shape and g.dtype == torch.float32, n
            _close(g, w, (B, T, C, D, missing, n))
        dx_only = tmix_prologue_bwd_tiled_plain(*targs, c, weights=False)
        assert torch.equal(dx_only[0], got[0]) and torch.equal(dx_only[1], got[1])
        assert dx_only[2:] == (None,) * 5


@pytest.mark.parametrize("B,T,C,D", [(3, 1, 128, 32), (1, 17, 64, 64), (3, 63, 128, 64),
                                     (1, 64, 128, 32), (3, 65, 64, 32), (3, 130, 128, 64)])
def test_tiled_mirror_matches_pallas_backward(B, T, C, D):
    args, cts = _inputs(B, T, C, D)
    _, vjp = jax.vjp(lambda *a: _prologue(*a, 1e-5, True), *map(jnp.asarray, args))
    targs = [torch.from_numpy(a) for a in args]
    for missing in MISSING:
        want = vjp(tuple(jnp.zeros_like(jnp.asarray(c)) if i in MISSING[missing] else jnp.asarray(c)
                         for i, c in enumerate(cts)))
        got = tmix_prologue_bwd_tiled_plain(*targs, _cts(cts, missing))
        for n, g, w in zip(NAMES, got, want):
            assert g.shape == w.shape, n
            _close(g, w, (B, T, C, D, missing, n))


def test_one_limb_operands_stay_within_the_card_limit():
    """One bf16 limb for every activation operand moves the gradients by
    ~1e-3 of max (the limbs' own rounding, 2^-9): far above the two-limb
    walk, still inside the 2e-2 the card holds bf16 gradients to."""
    args, cts = _inputs(3, 65, 128, 32)
    targs = [torch.from_numpy(a) for a in args]
    c = _cts(cts, "one")
    want = tmix_prologue_bwd_plain(*targs, c)
    one = tmix_prologue_bwd_tiled_plain(*targs, c, limbs=())
    for n, g, w in zip(NAMES, one, want):
        rel = (g - w).abs().max() / w.abs().max()
        assert REL < rel < 2e-2, (n, float(rel))


def test_b5_body_picks_k2s_rule():
    for dtype, C, D in ((torch.bfloat16, 2048, 32), (torch.bfloat16, 2048, 64),
                        (torch.bfloat16, 2050, 32), (torch.bfloat16, 2048, 16),
                        (torch.float32, 2048, 32)):
        assert b5_body(dtype, C, D) == k2_body(dtype, C, D)
    assert b5_body(torch.bfloat16, 2048, 32) == "tensor_cores"
    assert b5_body(torch.float32, 2048, 32) == "cuda_cores"
    assert set(B5_LIMBS) == {"xxx", "dm", "dpre", "h"}
