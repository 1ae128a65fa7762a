"""The chunked factoring of the port's WKV backward (the chunked bodies of
B.6 and B.7 in csrc/wkv_fused_bwd.cu), in plain PyTorch on the CPU:
``wkv6_fused_output_bwd_chunked_plain`` (GroupNorm and gate, K1's backward)
and ``wkv_bwd_chunked_plain`` (gn=False, B.8's backward, with per-row
``lengths`` and ``reverse``). Same numpy-seeded inputs on every side.

Against autograd through the port's sequential plain versions on fp64
inputs: every gradient within 2e-5 of max|plain|. The mirror computes in
fp64; the plain recurrence (wkv_reference) runs in fp32 whatever its
inputs, and the GroupNorm adjoint scales its rounding by up to 1/std(y).
Cases: chunks of 16 and 24 (24: a chunk that is not a power of two, where
the JAX package's backward once corrupted dv), T = 1, 15, 16, 17, 37,
strong (w in [2.5, 3.2]: a decay of 5e-6 to 2e-11 a step, where the decay
gradient of the sequential identity cancels to the last bit), wide (w in
[-8, 3]) and no decay (w = -8), N = 32 and 64.

Against jax.vjp of the JAX package's ``_wkv_fused`` and ``wkv_pallas``,
whose custom_vjps run ``_fused_bwd_pallas`` with gn True and False, in
interpret mode, at N = 32 and 64, the three decay ranges and T = 15, 17
and 37: every gradient within 2e-5 of max (fp32 on the JAX side),
except dw at strong decay, where the JAX backward's per-chunk suffix sum
cancels and misses fp64 autograd itself by more than a hundred times the
mirror's error: there the mirror is held to 2e-5 of autograd (and, where
the heads all decay strongly, to 5e-2 of JAX).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.ops.wkv_pallas import _wkv_fused
from rwkv_lm_ext_tpu.ops.wkv_pallas import wkv_pallas as jax_wkv_pallas
from rwkv_lm_ext_tpu_torch.ops.wkv import wkv_bwd_chunked_plain, wkv_bwd_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    check_head_size,
    k1_body,
    wkv6_fused_output_bwd_chunked_plain,
    wkv6_fused_output_bwd_plain,
    wkv_bwd_body,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

EPS = 6.4e-4
DECAYS = {"wide": (-8.0, 3.0), "strong": (2.5, 3.2), "none": (-8.0, -8.0)}
FUSED = ("dr", "dk", "dv", "dw", "du", "ds0", "dg", "dln_scale", "dln_bias")
UNFUSED = ("dr", "dk", "dv", "dw", "du", "ds0")


def _inputs(B, T, H, N, decay, seed):
    lo, hi = DECAYS[decay]
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(
        r=mk(B, T, H, N), k=mk(B, T, H, N), v=mk(B, T, H, N), g=mk(B, T, H, N),
        w=rng.uniform(lo, hi, size=(B, T, H, N)).astype(np.float32),
        u=0.5 * mk(H, N), sc=1 + 0.1 * mk(H * N), bi=0.1 * mk(H * N), s0=0.1 * mk(B, H, N, N),
        dout=mk(B, T, H * N), dy=mk(B, T, H, N), dsT=0.1 * mk(B, H, N, N),
    )


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= rel * scale, (name, err, scale)


FUSED_KEYS = ("r", "k", "v", "w", "u", "g", "sc", "bi", "s0", "dout", "dsT")


@pytest.mark.parametrize("chunk", [16, 24])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 37])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("N", [32, 64])
def test_fused_mirror_matches_autograd_of_the_plain_version(N, decay, T, chunk):
    x = _inputs(2, T, 2, N, decay, 100 * T + N + chunk)
    got = wkv6_fused_output_bwd_chunked_plain(*(_t(x[n]) for n in FUSED_KEYS), eps=EPS,
                                              chunk=chunk)
    want = wkv6_fused_output_bwd_plain(*(_t(x[n], torch.float64) for n in FUSED_KEYS), eps=EPS)
    assert all(g.dtype == torch.float32 for g in got)
    for name, g, w in zip(FUSED, got, want):
        assert g.shape == w.shape, name
        _close(g, w, 2e-5, name)


@pytest.mark.parametrize("chunk", [16, 24])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 37])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("N", [32, 64])
def test_unfused_mirror_matches_autograd_of_the_plain_version(N, decay, T, chunk):
    """With and without the bonus and an initial state, forwards and in
    reverse, over all T and over ragged prefixes (lengths 0, 1, T - 1)."""
    B = 3
    x = _inputs(B, T, 2, N, decay, 100 * T + N + chunk + 7)
    lengths = torch.tensor([0, min(1, T), max(T - 1, 1)])
    for reverse, ragged, with_u, with_s0 in ((False, False, True, True), (True, True, False, True),
                                             (True, False, True, False), (False, True, True, True)):
        keys = dict(r=x["r"], k=x["k"], v=x["v"], w=x["w"], u=x["u"] if with_u else None,
                    s0=x["s0"] if with_s0 else None, dy=x["dy"], dsT=x["dsT"])
        kw = dict(reverse=reverse, lengths=lengths if ragged else None)
        got = wkv_bwd_chunked_plain(*(_t(a) for a in keys.values()), chunk=chunk, **kw)
        want = wkv_bwd_plain(*(_t(a, torch.float64) for a in keys.values()), **kw)
        for name, g, w in zip(UNFUSED, got, want):
            assert (g is None) == (w is None), name
            if w is not None:
                _close(g, w, 2e-5, f"{name} reverse={reverse} ragged={ragged}")
        if ragged:
            beyond = (torch.arange(T)[None, :] >= lengths[:, None])[..., None, None]
            for g in got[:4]:
                assert float((g * beyond).abs().max()) == 0.0


@functools.partial(jax.jit, static_argnums=0)
def _jax_vjp(fn, args, cts):
    """jax.vjp of fn at args against cts, jitted: the interpret-mode Pallas
    kernels compile once instead of running op by op (same results, about a
    third faster here)."""
    return jax.vjp(fn, *args)[1](cts)


def _fused_jax(r, k, v, w, u, s0, g, sc, bi):
    return _wkv_fused(r, k, v, w, u, s0, g, sc, bi, EPS, 16, True, True)


def _unfused_jax(*a):
    return jax_wkv_pallas(*a, chunk_size=16, interpret=True, exact=True)


@functools.lru_cache(maxsize=None)
def _jax_fused(N, decay):
    """jax.vjp of _wkv_fused (chunk 16, interpret mode): B = 1, the fewest
    heads the Pallas kernel tiles (128 // N share a lane block), T = 37."""
    x = _inputs(1, 37, 128 // N, N, decay, 7 + N)
    return x, _jax_fused_vjp(x)


def _jax_fused_vjp(x):
    want = _jax_vjp(_fused_jax, tuple(jnp.asarray(x[n]) for n in ("r", "k", "v", "w", "u", "s0", "g",
                                                                   "sc", "bi")),
                    (jnp.asarray(x["dout"]), jnp.asarray(x["dsT"])))
    return [np.asarray(a) for a in want]


def _jax_unfused_vjp(x):
    want = _jax_vjp(_unfused_jax, tuple(jnp.asarray(x[n]) for n in ("r", "k", "v", "w", "u", "s0")),
                    (jnp.asarray(x["dy"]), jnp.asarray(x["dsT"])))
    return [np.asarray(a) for a in want]


def _hold_to_jax(names, got, want, exact, decay, jax_limit=5e-2):
    """Every gradient within 2e-5 of JAX's max, but dw at strong decay: there
    within `jax_limit` of JAX (None: not held to JAX) and 2e-5 of fp64
    autograd, which JAX misses by over a hundred times the mirror's error."""
    for name, g, jw, e in zip(names, got, want, exact):
        assert g.shape == jw.shape, name
        if name == "dw" and decay == "strong":
            if jax_limit is not None:
                _close(g, jw, jax_limit, name)
            _close(g, e, 2e-5, name + " vs autograd")
            jax_err = np.abs(np.asarray(jw, np.float64) - e.numpy()).max()
            assert jax_err > 100 * np.abs(g.double().numpy() - e.numpy()).max()
        else:
            _close(g, jw, 2e-5, name)


@pytest.mark.parametrize("N,decay,chunk", [(64, "wide", 24), (64, "strong", 16)])
def test_fused_mirror_matches_the_pallas_backward(N, decay, chunk):
    x, want = _jax_fused(N, decay)
    got = wkv6_fused_output_bwd_chunked_plain(*(_t(x[n]) for n in FUSED_KEYS), eps=EPS,
                                              chunk=chunk)
    exact = wkv6_fused_output_bwd_plain(*(_t(x[n], torch.float64) for n in FUSED_KEYS), eps=EPS)
    _hold_to_jax(FUSED, got, want, exact, decay)


# N = 32 at T next to a chunk's edge: 128 // 32 = 4 heads share the Pallas
# kernel's lane block, each with its own decay range, so one JAX call covers
# the three; dw is held head by head
MIXED = ("none", "strong", "wide", "wide")


def _mixed_inputs(T, seed):
    x = _inputs(1, T, len(MIXED), 32, "wide", seed)
    rng = np.random.default_rng(seed + 1)
    for h, decay in enumerate(MIXED):
        x["w"][:, :, h] = rng.uniform(*DECAYS[decay], size=x["w"][:, :, h].shape)
    return x


def _hold_to_jax_by_head(names, got, want, exact):
    """As _hold_to_jax; dw head by head, where JAX's dw in the strong head
    misses autograd by a fifth of that head's largest value: there the
    mirror is held to autograd alone."""
    for name, g, jw, e in zip(names, got, want, exact):
        if name == "dw":
            for h, decay in enumerate(MIXED):
                _hold_to_jax([name], [g[:, :, h]], [jw[:, :, h]], [e[:, :, h]], decay, None)
        else:
            _hold_to_jax([name], [g], [jw], [e], "wide")


@functools.lru_cache(maxsize=None)
def _jax_fused_mixed(T):
    x = _mixed_inputs(T, 40 + T)
    return x, _jax_fused_vjp(x)


@pytest.mark.parametrize("chunk", [16, 24])
def test_fused_mirror_matches_the_pallas_backward_at_n32_past_a_chunk_edge(chunk):
    """N = 32, T = 17, no, strong and wide decay."""
    x, want = _jax_fused_mixed(17)
    got = wkv6_fused_output_bwd_chunked_plain(*(_t(x[n]) for n in FUSED_KEYS), eps=EPS,
                                              chunk=chunk)
    exact = wkv6_fused_output_bwd_plain(*(_t(x[n], torch.float64) for n in FUSED_KEYS), eps=EPS)
    _hold_to_jax_by_head(FUSED, got, want, exact)


def test_unfused_mirror_matches_the_pallas_backward():
    """gn=False: jax.vjp of wkv_pallas with the bonus and an initial state,
    T = 37, chunks of 24 on the mirror's side."""
    N, chunk = 64, 24
    x = _inputs(1, 37, 128 // N, N, "wide", 11)
    keys = ("r", "k", "v", "w", "u", "s0", "dy", "dsT")
    want = _jax_unfused_vjp(x)
    got = wkv_bwd_chunked_plain(*(_t(x[n]) for n in keys), chunk=chunk)
    exact = wkv_bwd_plain(*(_t(x[n], torch.float64) for n in keys))
    _hold_to_jax(UNFUSED, got, want, exact, "wide")


@functools.lru_cache(maxsize=None)
def _jax_unfused_mixed(T):
    x = _mixed_inputs(T, 50 + T)
    return x, _jax_unfused_vjp(x)


@pytest.mark.parametrize("chunk", [16, 24])
def test_unfused_mirror_matches_the_pallas_backward_at_n32_short_of_a_chunk_edge(chunk):
    """N = 32, T = 15, no, strong and wide decay."""
    x, want = _jax_unfused_mixed(15)
    keys = ("r", "k", "v", "w", "u", "s0", "dy", "dsT")
    got = wkv_bwd_chunked_plain(*(_t(x[n]) for n in keys), chunk=chunk)
    exact = wkv_bwd_plain(*(_t(x[n], torch.float64) for n in keys))
    _hold_to_jax_by_head(UNFUSED, got, want, exact)


def test_body_selection_and_head_sizes():
    assert wkv_bwd_body(torch.bfloat16, 64) == "chunked" == wkv_bwd_body(torch.bfloat16, 32)
    assert wkv_bwd_body(torch.float32, 64) == "sequential"
    assert wkv_bwd_body(torch.bfloat16, 16) == "sequential" == k1_body(torch.bfloat16, 16)
    check_head_size(16, "K1")
    with pytest.raises(ValueError, match="XLA"):
        check_head_size(128, "K1")
    with pytest.raises(ValueError, match="head size 48"):
        check_head_size(48, "K1")
    x = _inputs(1, 3, 1, 32, "wide", 0)
    with pytest.raises(ValueError, match="chunk"):
        wkv6_fused_output_bwd_chunked_plain(*(_t(x[n]) for n in FUSED_KEYS), eps=EPS, chunk=0)
