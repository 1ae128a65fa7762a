"""The chunked factoring of the port's unfused WKV kernel B.8 (the chunked
body of csrc/wkv.cu, ``chunk_walk`` in its raw mode), in plain PyTorch on the
CPU (``wkv_chunked_plain``): K1's chunk factoring without the GroupNorm, over
each row's walk (forwards or in reverse, over a ragged prefix of
``lengths``). Same numpy-seeded fp32 inputs on every side.

Cases: T = 1, 15, 16, 17, 37 (a single step, chunk edges, a ragged last
chunk), chunks of 16 and 24 (24: not a power of two), N = 32 and 64, strong
decay (w in [2.5, 3.2]: 5e-6 .. 2e-11 a step), wide (w in [-8, 2.5]) and
none (w = -8: the state only grows); with and without the bonus u and an
initial state, forwards, in reverse, over ragged prefixes (lengths 0, 1 and
T - 2).

Tolerances, x max|reference|: y and the final state within 2e-5 of the
port's sequential plain version and of JAX's ``wkv_reference`` (the same
fp32 terms summed chunk by chunk instead of step by step: the limit the
sequential body is held to on the card, test_torch_ops.py's for a state);
within 1e-5 x max(1, max|state|) of ``wkv_pallas(interpret=True,
exact=True)``, whose own exact-A factoring (chunk 64) is up to 5.6e-5 off the
golden at T = 64 (test_torch_wkv_chunked.py holds K1's mirror to the same).
Without decay the state grows with T, so the state's limit follows its
magnitude beyond 11, as in test_torch_wkv_chunked.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.ops.wkv_pallas import wkv_pallas as jax_wkv_pallas
from rwkv_lm_ext_tpu.ops.wkv_reference import wkv_reference as jax_wkv_reference
from rwkv_lm_ext_tpu_torch.ops.wkv import WKV_BODIES, wkv_body, wkv_chunked_plain, wkv_plain

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DECAYS = {"wide": (-8.0, 2.5), "strong": (2.5, 3.2), "none": (-8.0, -8.0)}
# (u, s0, reverse, ragged)
VARIANTS = [(True, True, False, False), (False, False, False, False), (False, True, True, True),
            (True, False, False, True), (True, True, True, False)]


def _inputs(T, decay, N, B=3):
    lo, hi = DECAYS[decay]
    H = 128 // N
    rng = np.random.default_rng(1000 * T + N + len(decay))
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(r=mk(B, T, H, N), k=mk(B, T, H, N), v=mk(B, T, H, N),
                w=rng.uniform(lo, hi, size=(B, T, H, N)).astype(np.float32),
                u=0.5 * mk(H, N), s0=0.1 * mk(B, H, N, N),
                lengths=np.array([0, min(1, T), max(T - 2, 1)][:B], dtype=np.int32))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max() if want.size else 0.0, 1e-30), (what, err)


def _state_rel(s):
    """2e-5 of a state up to 11, growing with the state beyond (no decay)."""
    return 2e-5 * max(1.0, float(np.abs(np.asarray(s)).max()) / 11.0)


@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("L", [16, 24])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 37])
def test_raw_chunked_mirror_matches_the_sequential_recurrences(T, L, decay, N):
    a = _inputs(T, decay, N)
    for use_u, use_s0, reverse, ragged in VARIANTS:
        u, s0 = (a["u"] if use_u else None), (a["s0"] if use_s0 else None)
        lengths = _t(a["lengths"]) if ragged else None
        args = [_t(a[n]) for n in ("r", "k", "v", "w")] + [_t(u), _t(s0)]
        what = (T, L, decay, N, use_u, use_s0, reverse, ragged)
        y, sT = wkv_chunked_plain(*args, reverse=reverse, lengths=lengths, chunk=L)
        assert y.shape == (3, T, 128 // N, N) and y.dtype == torch.float32
        assert sT.shape == (3, 128 // N, N, N) and sT.is_contiguous()
        py, psT = wkv_plain(*args, reverse=reverse, lengths=lengths)
        _close(y, py, 2e-5, what + ("y",))
        _close(sT, psT, _state_rel(psT), what + ("sT",))
        if ragged:
            beyond = np.arange(T)[None, :] >= a["lengths"][:, None]
            assert not y.numpy()[beyond].any(), what
        else:
            # JAX's golden scans all T, forwards or from the last step down
            jy, js = jax_wkv_reference(*(None if x is None else jnp.asarray(x)
                                         for x in (a["r"], a["k"], a["v"], a["w"], u, s0)),
                                       reverse=reverse)
            _close(y, jy, 2e-5, what + ("y vs jax",))
            _close(sT, js, _state_rel(js), what + ("sT vs jax",))


@functools.lru_cache(maxsize=None)
def _pallas(T, decay, N):
    a = _inputs(T, decay, N, B=1)
    y, sT = jax_wkv_pallas(*(jnp.asarray(a[n]) for n in ("r", "k", "v", "w", "u", "s0")),
                           interpret=True, exact=True)
    return np.asarray(y), np.asarray(sT)


@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("T", [1, 16, 17, 37])
def test_raw_chunked_mirror_matches_pallas(T, decay, N):
    """The Pallas kernel in interpret mode (exact-A, chunk 64) on the same
    inputs, with u and s0, forwards (its contract has no lengths)."""
    a = _inputs(T, decay, N, B=1)
    y, sT = wkv_chunked_plain(*(_t(a[n]) for n in ("r", "k", "v", "w", "u", "s0")))
    py, psT = _pallas(T, decay, N)
    for got, want, name in ((y, py, "y"), (sT, psT, "sT")):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=name)


def test_wkv_body_picks_by_dtype_and_head_size_and_the_mirror_refuses_no_chunk():
    assert wkv_body(torch.bfloat16, 64) == "chunked" and wkv_body(torch.bfloat16, 32) == "chunked"
    assert wkv_body(torch.float32, 64) == "sequential" and wkv_body(torch.bfloat16, 16) == "sequential"
    assert set(WKV_BODIES) == {"sequential", "chunked"}
    a = _inputs(5, "wide", 64)
    args = [_t(a[n]) for n in ("r", "k", "v", "w", "u")]
    with pytest.raises(ValueError, match="chunk"):
        wkv_chunked_plain(*args, chunk=0)
    # an (H, N, N) initial state shared by every sequence
    y, sT = wkv_chunked_plain(*args, _t(a["s0"][0]))
    py, psT = wkv_plain(*args, _t(a["s0"][0]))
    _close(y, py, 2e-5, "shared s0 y")
    _close(sT, psT, 2e-5, "shared s0 sT")
