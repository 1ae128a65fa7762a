"""Plain mirrors of the redesigned B.13 and B.11 against the JAX package, on
the CPU.

``wkv6_decode_transposed_streamed_plain`` walks the heads in the order of
B.13's persistent grid, each through a stage of its block's ring, and writes
each tile back into the (possibly aliased) state; ``ffn_prep_warp_order_plain``
adds B.11's row sums in the kernel's order. Tolerances are those of the tests
they mirror: the transposed step 2e-4, as
tests/test_torch_decode_fused.py holds the Pallas experiment; B.11 2e-5 in
fp32 and atol=1e-4 / rtol=1e-2 in bf16, as ``test_ffn_prep_matches_jax``.
The streamed state is the plain step's bit for bit after a transpose (the
same products and sum per element).
"""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.ops import decode_fused as jdf
from rwkv_lm_ext_tpu.ops.wkv_decode import _decode_ref, _pick_bt_packed
from rwkv_lm_ext_tpu_torch.ops.decode_fused import (
    FFN_PREP_MAX_THREADS,
    ffn_prep_plain,
    ffn_prep_threads,
    ffn_prep_warp_order_plain,
)
from rwkv_lm_ext_tpu_torch.ops import _lib
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import (
    STREAM_HEAD_SIZES,
    b13_grid,
    b13_walk,
    transpose_state,
    wkv6_decode_step,
    wkv6_decode_step_plain,
    wkv6_decode_step_transposed,
    wkv6_decode_step_transposed_plain,
    wkv6_decode_transposed_streamed_plain,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = pathlib.Path(__file__).resolve().parent.parent
LN_X_EPS = 6.4e-4
EPS = 1e-5
H = 8                  # 8-aligned row blocks for the Pallas experiment at any B
ORDER = ("r", "k", "v", "w", "g", "u", "ln_scale", "ln_bias")
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=1e-4, rtol=1e-2)}


def _decode_inputs(seed, B, N):
    rng = np.random.default_rng(seed)
    C = H * N
    mk = lambda *sh: rng.normal(size=sh).astype(np.float32)
    return dict(
        r=mk(B, C), k=mk(B, C), v=mk(B, C),
        w=rng.uniform(-8, 2.5, size=(B, C)).astype(np.float32),
        g=mk(B, C), u=mk(H, N) * 0.5, ln_scale=1 + 0.1 * mk(C), ln_bias=0.1 * mk(C),
        state=mk(B, H, N, N) * 0.3,
    )


@functools.lru_cache(maxsize=None)
def _jax_reference(B, N):
    """The Pallas experiment (interpret mode) and _decode_ref on one input:
    (outputs, logical states) as numpy."""
    assert _pick_bt_packed(B, H, N) is not None          # reaches pallas_call
    spec = importlib.util.spec_from_file_location(
        "bench_decode_transposed", REPO / "scripts" / "bench_decode_transposed.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    a = _decode_inputs(100 * B + N, B, N)
    ja = [jnp.asarray(a[k]) for k in ORDER]
    s_log = jnp.asarray(a["state"])
    # under jit: one compile a shape, not one a primitive
    trans_t = jax.jit(functools.partial(bench.decode_step_transT, eps=LN_X_EPS, interpret=True))
    out_t, s_t = trans_t(*ja, bench.pack_T(s_log))
    out_r, s_r = jax.jit(_decode_ref, static_argnums=9)(
        *(x.reshape(B, H, N) for x in ja[:5]), *ja[5:], s_log, LN_X_EPS)
    return ((np.asarray(out_t), np.asarray(bench.unpack_T(s_t, N))),
            (np.asarray(out_r).reshape(B, H * N), np.asarray(s_r)))


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("N", STREAM_HEAD_SIZES)
@pytest.mark.parametrize("B", [1, 3, 8])
def test_streamed_decode_step_matches_jax(B, N, in_place):
    """B.13's order on 1 block, 5 blocks and one block a head,
    against the Pallas experiment and _decode_ref; its state equals the
    plain step's bit for bit after a transpose."""
    a = {k: torch.from_numpy(v) for k, v in _decode_inputs(100 * B + N, B, N).items()}
    state = a.pop("state")
    args = [a[k] for k in ORDER]
    plain_out, plain_s = wkv6_decode_step_plain(*args, state, eps=LN_X_EPS)
    tol = dict(rtol=2e-4, atol=2e-4)
    for grid in (1, 5, B * H):
        state_t = transpose_state(state)
        out_state = state_t if in_place else None
        out, s_t = wkv6_decode_transposed_streamed_plain(
            *args, state_t, eps=LN_X_EPS, grid=grid, out_state=out_state)
        assert s_t.shape == (B, H, N, N) and s_t.is_contiguous()
        assert (s_t.data_ptr() == state_t.data_ptr()) == in_place
        assert torch.equal(transpose_state(s_t), plain_s), grid
        for want_out, want_s in _jax_reference(B, N):
            np.testing.assert_allclose(out.numpy(), want_out, **tol)
            np.testing.assert_allclose(transpose_state(s_t).numpy(), want_s, **tol)
        np.testing.assert_allclose(out.numpy(), plain_out.numpy(), **tol)


@pytest.mark.parametrize("heads", [range(1, 101), range(101, 201), range(201, 301)])
def test_stream_walk_visits_every_head_once(heads):
    """b13_walk, for B * H from 1 to 300 and grids from 1 to 264: every head
    exactly once, block q's heads q, q + grid, ... in turn, and as many as
    the kernel's count (heads - 1 - q) // grid + 1."""
    for n in heads:
        for grid in range(1, 265):
            walk = b13_walk(n, grid).numpy()
            assert walk.shape[0] == grid
            assert (np.bincount(walk[walk >= 0], minlength=n) == 1).all(), (n, grid)
            q = np.arange(grid)
            assert ((walk >= 0).sum(1) == np.where(q < n, (n - 1 - q) // grid + 1, 0)).all()
            assert (walk[:, 0] == np.where(q < n, q, -1)).all()
            assert ((np.diff(walk, axis=1) == grid) | (walk[:, 1:] < 0)).all()


def test_stream_grid_is_at_most_one_block_a_head():
    """As many blocks as the card holds at once, never more than heads, and
    at least one."""
    for heads in (1, 2, 31, 32, 33, 396, 397, 2048):
        for per_sm in (1, 3, 4):
            for sms in (1, 132):
                grid = b13_grid(heads, per_sm, sms)
                assert grid == min(heads, per_sm * sms) and 1 <= grid <= heads
    assert b13_grid(32, 3, 132) == 32 and b13_grid(2048, 4, 132) == 528


@pytest.mark.parametrize("N", STREAM_HEAD_SIZES)
def test_transposed_step_on_the_cpu_is_the_plain_version(N):
    """On CPU tensors B.13's wrapper runs its plain version and launches
    nothing: the streamed order's bits in the state, in place and not, and
    the logical step's after a transpose."""
    a = {k: torch.from_numpy(v) for k, v in _decode_inputs(7 + N, 2, N).items()}
    state = a.pop("state")
    args = [a[k] for k in ORDER]
    before = wkv6_decode_step_transposed.launches
    want_out, want_s = wkv6_decode_step_transposed_plain(*args, transpose_state(state), eps=LN_X_EPS)
    out, s_t = wkv6_decode_step_transposed(*args, transpose_state(state), eps=LN_X_EPS)
    assert torch.equal(out, want_out) and torch.equal(s_t, want_s)
    buf = transpose_state(state)
    out, s_t = wkv6_decode_step_transposed(*args, buf, eps=LN_X_EPS, out_state=buf)
    assert s_t.data_ptr() == buf.data_ptr() and torch.equal(s_t, want_s)
    assert torch.equal(transpose_state(s_t), wkv6_decode_step(*args, state, eps=LN_X_EPS)[1])
    for grid in (1, 3, 2 * H):
        _, streamed = wkv6_decode_transposed_streamed_plain(
            *args, transpose_state(state), eps=LN_X_EPS, grid=grid)
        assert torch.equal(streamed, want_s), grid
    assert wkv6_decode_step_transposed.launches == before


def test_param_vectors_keep_a_shared_dtype():
    """The decode kernels read u, ln_scale and ln_bias as they come when the
    three share fp32 or bf16 (no cast a call); any other mix goes to fp32,
    which holds every bf16 value exactly."""
    bf, f32 = torch.ones(4, dtype=torch.bfloat16), torch.ones(4)
    for dtype in (torch.float32, torch.bfloat16):
        vecs = [torch.arange(4, dtype=dtype) for _ in range(3)]
        got, code = _lib.param_vectors(*vecs)
        assert code == _lib.DTYPE_CODES[dtype]
        assert all(g.data_ptr() == v.data_ptr() for g, v in zip(got, vecs))
    got, code = _lib.param_vectors(bf, f32, bf)
    assert code == _lib.DTYPE_CODES[torch.float32] and all(g.dtype == torch.float32 for g in got)
    got, code = _lib.param_vectors(torch.ones(4, dtype=torch.float16), f32)
    assert code == _lib.DTYPE_CODES[torch.float32] and torch.equal(got[0], f32)


def _ffn_inputs(seed, B, C):
    rng = np.random.default_rng(seed)
    mk = lambda *sh, s=1.0: (rng.normal(size=sh) * s).astype(np.float32)
    return [mk(B, C, s=2.0) + 0.5, mk(B, C), 1.0 + 0.1 * mk(C), 0.1 * mk(C),
            rng.uniform(size=C).astype(np.float32), rng.uniform(size=C).astype(np.float32)]


@pytest.mark.parametrize("dtype,pdtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                          ("bfloat16", "float32")])
@pytest.mark.parametrize("C", [256, 264, 2048])
@pytest.mark.parametrize("B", [1, 6, 16])
def test_ffn_prep_warp_order_matches_jax(B, C, dtype, pdtype):
    """B.11's order of the row sums against the Pallas kernel (interpret
    mode) and _ffn_prep_ref, activations and (C,) parameters each in fp32 or
    bf16; and against the plain version."""
    args = _ffn_inputs(B * C, B, C)
    jd, jp = getattr(jnp, dtype), getattr(jnp, pdtype)
    td, tp = getattr(torch, dtype), getattr(torch, pdtype)
    jargs = ([jnp.asarray(args[0]).astype(jd), jnp.asarray(args[1])]
             + [jnp.asarray(a).astype(jp) for a in args[2:]])
    targs = ([torch.from_numpy(args[0]).to(td), torch.from_numpy(args[1])]
             + [torch.from_numpy(a).to(tp) for a in args[2:]])
    got = ffn_prep_warp_order_plain(*targs, EPS)
    assert [g.dtype for g in got] == [td, td, torch.float32]
    for want in (jdf.ffn_prep_fused(*jargs, EPS, interpret=True), jdf._ffn_prep_ref(*jargs, EPS)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                       **TOL[dtype])
    for g, w in zip(got, ffn_prep_plain(*targs, EPS)):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **TOL[dtype])


def test_ffn_prep_threads_cover_the_row():
    """One thread a chunk of eight values in whole warps, up to the most a
    block takes; past that a thread owns several chunks."""
    for C in (1, 7, 8, 100, 256, 257, 264, 2048, 4096, 4104, 8192):
        t = ffn_prep_threads(C)
        assert t % 32 == 0 and 32 <= t <= FFN_PREP_MAX_THREADS
        assert 8 * t >= C or t == FFN_PREP_MAX_THREADS
        assert 8 * (t - 32) < C or t == 32
    assert ffn_prep_threads(2048) == 256 and ffn_prep_threads(4096) == 512


def test_ffn_prep_warp_order_past_one_chunk_a_thread():
    """C = 8200 and C = 100: the generic path's shapes (several chunks a
    thread, a short last chunk) give the plain version's values."""
    for B, C in ((2, 8200), (3, 100)):
        targs = [torch.from_numpy(a) for a in _ffn_inputs(C, B, C)]
        for g, w in zip(ffn_prep_warp_order_plain(*targs, EPS), ffn_prep_plain(*targs, EPS)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL["float32"])
