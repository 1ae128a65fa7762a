"""The port's unfused WKV family (CPU, the plain versions) against the JAX
package on the same numpy-seeded inputs: the sequential golden with
``reverse`` and without a bonus, ``wkv`` against the Pallas kernel B.8 in
interpret mode and its two-pass ``gn=False`` backward, ``_flip_valid_prefix``
and ``wkv6_bi``; and the port's own ``lengths`` contract.

Tolerances, in fp32 on both sides: 1e-5 of the largest |JAX value| for y and
the final state (the Pallas kernel factors each chunk into matrix products,
the port runs the sequential recurrence), 1e-4 for the gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.ops.wkv import _flip_valid_prefix as jax_flip_valid_prefix
from rwkv_lm_ext_tpu.ops.wkv import wkv6_bi as jax_wkv6_bi
from rwkv_lm_ext_tpu.ops.wkv_pallas import wkv_pallas as jax_wkv_pallas
from rwkv_lm_ext_tpu.ops.wkv_reference import wkv_reference as jax_wkv_reference
from rwkv_lm_ext_tpu_torch.ops.wkv import (
    _flip_valid_prefix,
    wkv,
    wkv6_bi,
    wkv6_bi_plain,
    wkv_bwd,
    wkv_bwd_plain,
    wkv_plain,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_reference import wkv_reference

torch.set_num_threads(1)  # tier-1 runs several pytest workers

SHAPES = [(2, 32, 2, 64), (2, 41, 4, 32)]


def _close(got, want, rel, name=""):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else a for a in (got, want))
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (name, err, np.abs(want).max())


def _inputs(shape, seed, with_u=True, with_s0=True):
    """r, k, v ~ N(0, 1), w ~ U(-8, 3) (decays from ~1 down to e^-20), u and
    s0 ~ N(0, 1), as numpy fp32; u and s0 None when not wanted."""
    B, T, H, N = shape
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    w = rng.uniform(-8, 3, shape).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32) if with_u else None
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32) if with_s0 else None
    return r, k, v, w, u, s0


def _t(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("reverse,with_u,with_s0", [
    (False, True, True), (True, True, True), (True, False, False), (False, False, True)])
def test_wkv_reference_matches_jax(reverse, with_u, with_s0):
    args = _inputs((2, 19, 2, 32), 0, with_u, with_s0)
    y, sT = wkv_reference(*_t(args), reverse=reverse)
    jy, jsT = jax_wkv_reference(*_j(args), reverse=reverse)
    assert y.dtype == sT.dtype == torch.float32
    _close(y, jy, 1e-5, "y")
    _close(sT, jsT, 1e-5, "sT")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_u_s0", [True, False])
def test_wkv_matches_the_pallas_kernel_and_the_golden(shape, with_u_s0):
    """On CPU tensors ``wkv`` is ``wkv_plain``. Against the Pallas kernel
    (interpret mode, exact factoring) the state holds to 1e-5 of max|S|."""
    args = _inputs(shape, 1, with_u_s0, with_u_s0)
    y, sT = wkv(*_t(args))
    py, psT = wkv_plain(*_t(args))
    assert torch.equal(y, py) and torch.equal(sT, psT)
    gy, gsT = jax_wkv_reference(*_j(args))
    _close(y, gy, 1e-5, "y vs golden")
    _close(sT, gsT, 1e-5, "sT vs golden")
    ky, ksT = jax_wkv_pallas(*_j(args), interpret=True, exact=True)
    _close(y, ky, 1e-5, "y vs pallas")
    _close(sT, ksT, 1e-5, "sT vs pallas")


@pytest.mark.parametrize("shape", SHAPES)
def test_wkv_backward_matches_the_pallas_two_pass_backward(shape):
    """``wkv_bwd_plain`` is torch.autograd.grad through ``wkv_plain``; the
    JAX side is jax.vjp of ``wkv_pallas``, whose custom_vjp runs the fused
    backward kernels with gn=False at these head geometries (P * N = 128)."""
    B, T, H, N = shape
    args = _inputs(shape, 2)
    rng = np.random.default_rng(3)
    dy = rng.standard_normal(shape).astype(np.float32)
    dsT = rng.standard_normal((B, H, N, N)).astype(np.float32)
    got = wkv_bwd_plain(*_t(args), torch.from_numpy(dy), torch.from_numpy(dsT))
    assert all(torch.equal(a, b) for a, b in zip(
        got, wkv_bwd(*_t(args), torch.from_numpy(dy), torch.from_numpy(dsT))))

    leaves = [t.requires_grad_() for t in _t(args)]
    y, sT = wkv_plain(*leaves)
    (y * torch.from_numpy(dy)).sum().add((sT * torch.from_numpy(dsT)).sum()).backward()
    for g, leaf, name in zip(got, leaves, "r k v w u s0".split()):
        _close(g, leaf.grad.numpy(), 1e-6, name + " vs autograd")

    _, vjp = jax.vjp(lambda *a: jax_wkv_pallas(*a, interpret=True, exact=True), *_j(args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dsT)))
    for g, jg, name in zip(got, want, "r k v w u s0".split()):
        _close(g, jg, 1e-4, name + " vs pallas vjp")


def test_wkv_backward_leaves_out_what_is_absent():
    r, k, v, w, _, _ = _inputs((1, 5, 2, 32), 4)
    dy = torch.ones(1, 5, 2, 32)
    got = wkv_bwd_plain(*_t((r, k, v, w)), None, None, dy, None)
    assert got[4] is None and got[5] is None and all(g is not None for g in got[:4])
    shared = torch.from_numpy(_inputs((1, 5, 2, 32), 5)[5][0])       # (H, N, N)
    ds0 = wkv_bwd_plain(*_t((r, k, v, w)), None, shared, dy, None)[5]
    assert ds0.shape == shared.shape


@pytest.mark.parametrize("lengths", [None, [7, 7, 7], [0, 1, 5]])
def test_flip_valid_prefix_and_wkv6_bi_match_jax(lengths):
    shape = (3, 7, 2, 32)
    r, k, v, w, u, _ = _inputs(shape, 6, with_s0=False)
    L = None if lengths is None else torch.tensor(lengths)
    jL = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    if lengths is not None:
        got = _flip_valid_prefix(torch.from_numpy(r), L)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_flip_valid_prefix(jnp.asarray(r), jL)))
        flat = _flip_valid_prefix(torch.from_numpy(r[..., 0, 0]), L)      # a 2-D input
        np.testing.assert_array_equal(flat.numpy(), got.numpy()[..., 0, 0])

    leaves = [t.requires_grad_() for t in _t((r, k, v, w, u))]
    y = wkv6_bi(*leaves, L)
    _close(y, wkv6_bi_plain(*leaves, L), 1e-6, "vs the flip composition")
    jy, vjp = jax.vjp(lambda *a: jax_wkv6_bi(*a, jL, backend="reference"), *_j((r, k, v, w, u)))
    _close(y, jy, 1e-5, "y")
    dy = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    y.backward(torch.from_numpy(dy))
    for leaf, jg, name in zip(leaves, vjp(jnp.asarray(dy)), "r k v w u".split()):
        _close(leaf.grad, jg, 1e-5, "d" + name)


@pytest.mark.parametrize("reverse", [False, True])
def test_lengths_hold_the_scan_to_each_rows_prefix(reverse):
    """The port's own argument: row b equals the scan of its first
    lengths[b] steps alone, y is zero beyond them, the final state is the
    state after them, and no gradient reaches the rows beyond."""
    shape = (3, 9, 2, 32)
    args = _t(_inputs(shape, 8, with_u=not reverse))
    lengths = torch.tensor([0, 1, 6])
    leaves = [None if a is None else a.requires_grad_() for a in args]
    y, sT = wkv(*leaves, reverse=reverse, lengths=lengths)
    for b, n in enumerate(lengths.tolist()):
        row = [None if a is None else (a[b:b + 1] if a.dim() == 4 and a.shape[0] == 3 else a)
               for a in args]
        row[:4] = [a[:, :n] for a in row[:4]]
        want_y, want_s = wkv_plain(*row, reverse=reverse)
        if n:
            _close(y[b, :n], want_y[0].detach().numpy(), 1e-6, f"y row {b}")
        _close(sT[b], want_s[0].detach().numpy(), 1e-6, f"sT row {b}")
        assert float(y[b, n:].abs().max()) == 0.0
    (y.sum() + sT.sum()).backward()
    for leaf in leaves[:4]:
        assert torch.isfinite(leaf.grad).all()
        assert float(leaf.grad[2, 6:].abs().max()) == 0.0 and float(leaf.grad[0].abs().max()) == 0.0
