"""The chunked factoring of the port's fused WKV kernel, in plain PyTorch on
the CPU (``wkv6_fused_output_chunked_plain``), against the JAX package: the
sequential golden ``wkv_reference`` with the GroupNorm and gate tail of
``_fused_ref``, and the Pallas kernel in interpret mode. Same numpy-seeded
fp32 inputs on both sides.

The factoring scales r and k inside a chunk only by exponentials of sums of
-exp(w), never of a positive number, so it has to hold any decay without an
exact/rescale choice: strong decay (w in [2.5, 3.2], per-step decay down to
2e-11), no decay (w = -8, sums only grow), a chunk length that is not a power
of two (24: the JAX package's backward once corrupted dv there), T that is no
multiple of the chunk, T = 1.

Also: the prologue's plain version with its product operands rounded to bf16
(the arithmetic of a default-precision MXU product and of the tensor-core
kernel body) against the Pallas prologue in interpret mode on bf16 inputs.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.ops.ddlerp_pallas import tmix_prologue as jax_tmix_prologue
from rwkv_lm_ext_tpu.ops.wkv_pallas import wkv6_fused_output as jax_wkv6_fused_output
from rwkv_lm_ext_tpu.ops.wkv_reference import wkv_reference as jax_wkv_reference
from rwkv_lm_ext_tpu_torch.ops.ddlerp import k2_body, tmix_prologue_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    k1_body,
    wkv6_fused_output_chunked_plain,
    wkv6_fused_output_plain,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

EPS = 6.4e-4
DECAYS = {"wide": (-8.0, 2.5), "strong": (2.5, 3.2), "none": (-8.0, -8.0)}


def _inputs(T, decay, N):
    """B = 1 and the fewest heads the Pallas kernel tiles natively
    (128 // N heads share a lane block)."""
    lo, hi = DECAYS[decay]
    B, H = 1, 128 // N
    rng = np.random.default_rng(1000 * T + N + len(decay))
    mk = lambda: rng.normal(size=(B, T, H, N)).astype(np.float32)
    r, k, v, g = mk(), mk(), mk(), mk()
    w = rng.uniform(lo, hi, size=(B, T, H, N)).astype(np.float32)
    u = (rng.normal(size=(H, N)) * 0.5).astype(np.float32)
    sc = rng.normal(1.0, 0.1, size=H * N).astype(np.float32)
    bi = rng.normal(0.0, 0.1, size=H * N).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
    return r, k, v, w, u, g, sc, bi, s0


def _j(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


@functools.lru_cache(maxsize=None)
def _golden(T, decay, with_state, N):
    """JAX's sequential recurrence, then the tail of ``_fused_ref``."""
    r, k, v, w, u, g, sc, bi, s0 = _inputs(T, decay, N)
    y, sT = jax_wkv_reference(*_j(r, k, v, w, u, s0 if with_state else None))
    y = np.asarray(y, np.float64)
    mu = y.mean(-1, keepdims=True)
    var = ((y - mu) ** 2).mean(-1, keepdims=True)
    yn = ((y - mu) / np.sqrt(var + EPS)).reshape(1, T, -1)
    return (yn * sc + bi) * g.reshape(1, T, -1), np.asarray(sT)


@functools.lru_cache(maxsize=None)
def _pallas(T, decay, N):
    args = _inputs(T, decay, N)
    out, sT = jax_wkv6_fused_output(*_j(*args), eps=EPS, interpret=True)
    return np.asarray(out), np.asarray(sT)


@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("with_state", [True, False], ids=["s0", "zeros"])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("L", [16, 24])
@pytest.mark.parametrize("T", [1, 16, 37, 64, 65])
def test_chunked_mirror_matches_jax(T, L, decay, with_state, N):
    r, k, v, w, u, g, sc, bi, s0 = _inputs(T, decay, N)
    s0 = s0 if with_state else None
    tensors = [None if a is None else torch.from_numpy(a) for a in (r, k, v, w, u, g, sc, bi, s0)]
    out, sT = wkv6_fused_output_chunked_plain(*tensors, eps=EPS, chunk=L)
    assert out.shape == (1, T, 128) and out.dtype == torch.float32
    assert sT.shape == (1, 128 // N, N, N) and sT.is_contiguous()
    want_out, want_s = _golden(T, decay, with_state, N)
    # the gated output: fp32 sums in another order, through a normalisation
    # (the limit test_torch_ops.py holds the plain version to)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=3e-4, atol=3e-4)
    # the state against the sequential golden: the same terms summed chunk by
    # chunk instead of step by step, 2e-5 for states up to 11 as in
    # test_torch_ops.py; without decay the state grows with T (to 30 at
    # T = 65), so the limit follows its magnitude beyond that
    scale = max(1.0, np.abs(want_s).max() / 11.0)
    np.testing.assert_allclose(sT.numpy(), want_s, rtol=0, atol=2e-5 * scale)
    # the port's own sequential plain version, to the same limits
    plain_out, plain_s = wkv6_fused_output_plain(*tensors, eps=EPS)
    np.testing.assert_allclose(out.numpy(), plain_out.numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(sT.numpy(), plain_s.numpy(), rtol=0, atol=2e-5 * scale)
    if with_state:
        # the Pallas kernel (exact-A, chunk 64) on the same inputs; its own
        # factoring is up to 5.6e-5 off the golden at T = 64, so the state is
        # held to 1e-5 of its magnitude, as in test_torch_ops.py
        p_out, p_s = _pallas(T, decay, N)
        np.testing.assert_allclose(out.numpy(), p_out, rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(sT.numpy(), p_s, rtol=0, atol=1e-5 * max(1.0, np.abs(p_s).max()))


def test_chunked_mirror_takes_a_shared_initial_state_and_refuses_no_chunk():
    """(H, N, N) shared by every sequence, as state tuning passes it."""
    r, k, v, w, u, g, sc, bi, s0 = (torch.from_numpy(a) for a in _inputs(37, "wide", 64))
    r2, k2, v2, w2, g2 = (torch.cat([t, t.flip(1)]) for t in (r, k, v, w, g))
    out, sT = wkv6_fused_output_chunked_plain(r2, k2, v2, w2, u, g2, sc, bi, s0[0], eps=EPS)
    want, want_s = wkv6_fused_output_plain(r2, k2, v2, w2, u, g2, sc, bi, s0[0], eps=EPS)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(sT.numpy(), want_s.numpy(), rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="chunk"):
        wkv6_fused_output_chunked_plain(r, k, v, w, u, g, sc, bi, eps=EPS, chunk=0)


@pytest.mark.parametrize("T,C,D", [(128, 128, 32), (256, 256, 64)])
def test_prologue_with_bf16_products_matches_pallas_on_bf16_inputs(T, C, D):
    """bf16 inputs through the Pallas prologue in interpret mode (whose CPU
    products take the fp32 xxx and h as they are) against the plain version
    with xxx, h and the weights rounded to bf16 before each product. Both
    round their outputs to bf16, so an output may land one bf16 step (at
    most 2^-7 of its value) apart wherever the two sides fall on either side
    of a rounding boundary; the operand rounding itself moves m by ~1e-3 and
    an output by less than that step. Limit: one bf16 step of the largest
    output, 2^-7 max|want|."""
    rng = np.random.default_rng(C)
    B = 2
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    args = (bf(rng.normal(size=(B, T, C))), bf(rng.normal(size=(B, C))),
            bf(rng.normal(1.0, 0.2, size=C)), bf(rng.normal(0.0, 0.2, size=C)),
            bf(rng.uniform(0, 1, size=(6, C))), bf(rng.normal(size=(C, 5 * D)) * 0.1),
            bf(rng.normal(size=(5, D, C)) * 0.1))
    want = jax_tmix_prologue(*(jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in args),
                             eps=1e-5, interpret=True)
    got = tmix_prologue_plain(*args, eps=1e-5, product_dtype=torch.bfloat16)
    exact = tmix_prologue_plain(*args, eps=1e-5)
    assert len(got) == 6
    for g_, e_, w_ in zip(got, exact, want):
        assert g_.dtype == torch.bfloat16 and g_.shape == (B, T, C)
        w_ = np.asarray(w_.astype(jnp.float32))
        limit = 2.0 ** -7 * np.abs(w_).max()
        assert np.abs(g_.float().numpy() - w_).max() <= limit
        # and the rounding of the operands is what separates it from the
        # plain version at full precision: no more than the same step
        assert (g_.float() - e_.float()).abs().max().item() <= limit


def test_kernel_bodies_are_chosen_from_dtype_and_shape_alone():
    """bf16 runs the redesigned bodies wherever they take the shape; fp32,
    and bf16 at a C that is no multiple of 8 or an unusual D, the first
    versions. No other input decides."""
    assert k1_body(torch.bfloat16) == "chunked" and k1_body(torch.float32) == "sequential"
    for C, D, want in ((2048, 32, "tensor_cores"), (4096, 64, "tensor_cores"),
                       (2056, 32, "tensor_cores"), (2050, 32, "cuda_cores"),
                       (256, 8, "cuda_cores"), (2048, 16, "cuda_cores")):
        assert k2_body(torch.bfloat16, C, D) == want
        assert k2_body(torch.float32, C, D) == "cuda_cores"

