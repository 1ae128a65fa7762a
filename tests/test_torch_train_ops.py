"""Gradients of the port's kernels' plain versions (CPU) against the JAX
package's custom_vjp backward kernels (Pallas B.5, B.6 + B.7, interpreted),
on the same numpy-seeded fp32 inputs and cotangents; the loss, schedule and
optimizer against their JAX counterparts; and the autograd.Function
plumbing of the kernel route, driven on the CPU with the kernels swapped for
their plain versions.

Tolerances (relative to the largest |JAX gradient|): 5e-4 for the prologue
and 1e-4 for the fused WKV (the Pallas kernels' chunked fp32 factoring
against the port's sequential fp32 recurrence), 1e-5 for LayerNorm, 1e-6
for the loss and the optimizer (one fp32 rounding order against another).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rwkv_lm_ext_tpu.config import TrainConfig as JaxTrainConfig
from rwkv_lm_ext_tpu.ops.ddlerp_pallas import _prologue
from rwkv_lm_ext_tpu.ops.ln_pallas import layer_norm_pallas
from rwkv_lm_ext_tpu.ops.wkv_pallas import _wkv_fused
from rwkv_lm_ext_tpu.train.losses import causal_lm_loss as jax_causal_lm_loss
from rwkv_lm_ext_tpu.train.optim import make_optimizer as jax_make_optimizer
from rwkv_lm_ext_tpu.train.optim import make_schedule as jax_make_schedule
from rwkv_lm_ext_tpu_torch.config import TrainConfig
from rwkv_lm_ext_tpu_torch.ops import ddlerp, launch_counts, ln, wkv_fused
from rwkv_lm_ext_tpu_torch.ops.ddlerp import (
    tmix_prologue_bwd,
    tmix_prologue_bwd_plain,
    tmix_prologue_plain,
)
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import wkv6_decode_step
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    wkv6_fused_output_bwd,
    wkv6_fused_output_bwd_plain,
    wkv6_fused_output_plain,
)
from rwkv_lm_ext_tpu_torch.train.losses import causal_lm_loss
from rwkv_lm_ext_tpu_torch.train.optim import make_optimizer, make_schedule

torch.set_num_threads(1)  # tier-1 runs several pytest workers


def _t(*arrays, grad=False):
    return tuple(torch.tensor(np.asarray(a), requires_grad=grad) for a in arrays)


def _close_rel(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-30, (name, err, np.abs(want).max())


def _prologue_inputs(rng, B, T, C, D):
    return (
        rng.normal(size=(B, T, C)).astype(np.float32),
        rng.normal(size=(B, C)).astype(np.float32),
        (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32),
        (0.1 * rng.normal(size=C)).astype(np.float32),
        rng.uniform(0, 1, size=(6, C)).astype(np.float32),
        (rng.normal(size=(C, 5 * D)) * 0.1).astype(np.float32),
        (rng.normal(size=(5, D, C)) * 0.1).astype(np.float32),
    )


def test_prologue_grads_match_pallas_backward():
    """(B, T, C, D) = (2, 128, 256, 16): T=128 with the Pallas backward's
    TB=64 crosses a block boundary; every input's gradient."""
    rng = np.random.default_rng(0)
    B, T, C, D = 2, 128, 256, 16
    args = _prologue_inputs(rng, B, T, C, D)
    cts = [rng.normal(size=(B, T, C)).astype(np.float32) for _ in range(6)]
    _, vjp = jax.vjp(lambda *a: _prologue(*a, 1e-5, True), *map(jnp.asarray, args))
    want = vjp(tuple(map(jnp.asarray, cts)))
    got = tmix_prologue_bwd(*_t(*args), _t(*cts), eps=1e-5)
    names = ["x", "shift", "scale", "bias", "maa", "w1", "w2"]
    assert len(got) == 7
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        _close_rel(g.numpy(), w, 5e-4, name)


def _wkv_inputs(rng, B, T, H, N, w_hi=3.0):
    mk = lambda: rng.normal(size=(B, T, H, N)).astype(np.float32)
    return (
        mk(), mk(), mk(),
        rng.uniform(-8, w_hi, size=(B, T, H, N)).astype(np.float32),   # decays 1 .. e^-20
        (rng.normal(size=(H, N)) * 0.5).astype(np.float32),
        mk(),
        rng.normal(1.0, 0.1, size=H * N).astype(np.float32),
        rng.normal(0.0, 0.1, size=H * N).astype(np.float32),
        (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("B,T,H,N", [(2, 32, 2, 64), (2, 41, 4, 32)])
def test_fused_wkv_grads_match_pallas_backward(B, T, H, N):
    """P*N = 128 engages B.6/B.7 in the JAX package; T=41 pads its chunks;
    w up to +3; non-zero s0 and dsT. All nine gradients."""
    rng = np.random.default_rng(T)
    r, k, v, w, u, g, sc, bi, s0 = _wkv_inputs(rng, B, T, H, N)
    dout = rng.normal(size=(B, T, H * N)).astype(np.float32)
    dsT = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
    eps = 6.4e-4
    _, vjp = jax.vjp(
        lambda r, k, v, w, u, s0, g, sc, bi: _wkv_fused(r, k, v, w, u, s0, g, sc, bi, eps, 16,
                                                        True, True),
        *map(jnp.asarray, (r, k, v, w, u, s0, g, sc, bi)),
    )
    jr, jk, jv, jw, ju, js0, jg, jsc, jbi = vjp((jnp.asarray(dout), jnp.asarray(dsT)))
    got = wkv6_fused_output_bwd(*_t(r, k, v, w, u, g, sc, bi, s0), *_t(dout, dsT), eps=eps)
    names = ["dr", "dk", "dv", "dw", "du", "ds0", "dg", "dln_scale", "dln_bias"]
    for name, a, want in zip(names, got, (jr, jk, jv, jw, ju, js0, jg, jsc, jbi)):
        assert a.shape == want.shape, name
        _close_rel(a.numpy(), want, 1e-4, name)


def test_bwd_plain_versions_equal_autograd_of_the_forwards():
    rng = np.random.default_rng(3)
    args = _t(*_prologue_inputs(rng, 2, 9, 64, 8), grad=True)
    cts = list(_t(*[rng.normal(size=(2, 9, 64)).astype(np.float32) for _ in range(6)]))
    cts[5] = None                                   # dxln unused, as in the model
    outs = tmix_prologue_plain(*args)
    want = torch.autograd.grad([o for o, c in zip(outs, cts) if c is not None], args,
                               [c for c in cts if c is not None])
    got = tmix_prologue_bwd_plain(*(a.detach() for a in args), cts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dx_only = tmix_prologue_bwd(*(a.detach() for a in args), cts, weights=False)
    assert torch.equal(dx_only[0], want[0]) and torch.equal(dx_only[1], want[1])
    assert dx_only[2:] == (None,) * 5

    r, k, v, w, u, g, sc, bi, s0 = _wkv_inputs(rng, 2, 7, 2, 32)
    s0 = s0[0]                                      # (H, N, N) shared by the batch
    args = _t(r, k, v, w, u, g, sc, bi, s0, grad=True)
    out, sT = wkv6_fused_output_plain(*args, eps=1e-3)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad([out], args, [dout])
    got = wkv6_fused_output_bwd_plain(*(a.detach() for a in args), dout, None, eps=1e-3)
    dr, dk, dv, dw, du, ds0, dg, dsc, dbi = got
    assert ds0.shape == (2, 32, 32)
    for a, b in zip((dr, dk, dv, dw, du, dg, dsc, dbi, ds0), want):
        assert torch.equal(a, b)


def test_layer_norm_grads_match_pallas():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(64, 128)) * 2 + 0.5).astype(np.float32)
    sc = rng.normal(1.0, 0.2, size=128).astype(np.float32)
    bi = rng.normal(0.0, 0.2, size=128).astype(np.float32)
    dy = rng.normal(size=(64, 128)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: layer_norm_pallas(*a, 1e-5, interpret=True),
                     *map(jnp.asarray, (x, sc, bi)))
    want = vjp(jnp.asarray(dy))
    args = _t(x, sc, bi, grad=True)
    got = torch.autograd.grad(layer_norm(*args, 1e-5), args, torch.from_numpy(dy))
    for name, g, w in zip(("x", "scale", "bias"), got, want):
        _close_rel(g.numpy(), w, 1e-5, name)


def test_causal_lm_loss_and_grad_match_jax():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 11, 97)) * 3).astype(np.float32)
    labels = rng.integers(0, 97, size=(3, 11))
    labels[0, :4] = -100
    labels[2, :] = -100
    want, want_g = jax.value_and_grad(jax_causal_lm_loss)(jnp.asarray(logits), jnp.asarray(labels))
    lt = torch.tensor(logits, requires_grad=True)
    got = causal_lm_loss(lt, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    _close_rel(lt.grad.numpy(), want_g, 1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "exp", "linear", "constant"])
def test_schedule_matches_jax(schedule):
    kw = dict(lr_init=3e-4, lr_final=1e-5, warmup_steps=10, total_steps=50, lr_schedule=schedule)
    want = jax_make_schedule(JaxTrainConfig(**kw))
    got = make_schedule(TrainConfig(**kw))
    for step in range(61):   # JAX evaluates in fp32: its rounding is ~1e-7 of lr_init
        np.testing.assert_allclose(got(step), float(want(step)), rtol=0, atol=1e-6 * 3e-4,
                                   err_msg=str(step))


def test_three_optimizer_steps_match_the_optax_chain():
    """Clip active (norm above grad_clip), weight decay on the leaves that
    are ndim >= 2 in the JAX package's layout (its time_decay is a flat
    vector, the port's (1, 1, A)), the 2x (time_decay) and 3x (time_first) lr
    groups."""
    rng = np.random.default_rng(6)
    shapes = {"blocks.0.att.time_decay": (1, 1, 16), "blocks.0.att.time_first": (4, 4),
              "blocks.0.att.key.weight": (8, 16), "blocks.0.ln1.weight": (16,)}
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rng.normal(size=s) * 3).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    kw = dict(lr_init=1e-2, lr_final=1e-3, warmup_steps=1, total_steps=3, weight_decay=0.1,
              grad_clip=1.0)
    # JAX: a dict tree whose paths hold the same names, vectors flat
    def jax_layout(a):
        return jnp.asarray(a.reshape(-1) if a.shape[:-1] == (1, 1) else a)

    jparams = {n: jax_layout(p) for n, p in params.items()}
    tx = jax_make_optimizer(JaxTrainConfig(**kw), jparams)
    state = tx.init(jparams)
    for gr in grads:
        upd, state = tx.update({n: jax_layout(g) for n, g in gr.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
    tparams = {n: torch.nn.Parameter(torch.tensor(p)) for n, p in params.items()}
    opt = make_optimizer(TrainConfig(**kw), list(tparams.items()))
    norms = []
    for gr in grads:
        for n, p in tparams.items():
            p.grad = torch.tensor(gr[n])
        norms.append(float(opt.step()))
    assert norms[0] > 1.0    # the clip was active
    for n in shapes:
        _close_rel(tparams[n].detach().numpy().reshape(jparams[n].shape), jparams[n], 1e-6, n)


def _swap_kernels_for_plain(monkeypatch):
    """Route the autograd Functions' kernel launches to the plain versions,
    so their plumbing (saved inputs, None cotangents, dtypes, the shared
    initial state) runs on CPU tensors."""
    monkeypatch.setattr(ln, "_launch_k3", lambda x, s, b, eps: layer_norm_plain(x, s, b, eps))
    monkeypatch.setattr(ddlerp, "_launch_k2", lambda x, *a: tmix_prologue_plain(x, *a[:-1], eps=a[-1]))
    monkeypatch.setattr(ddlerp, "tmix_prologue_bwd",
                        lambda *a, eps, weights: tmix_prologue_bwd_plain(*a, eps=eps))
    monkeypatch.setattr(wkv_fused, "_launch_k1",
                        lambda r, k, v, w, u, g, sc, bi, s0, eps:
                        wkv6_fused_output_plain(r, k, v, w, u, g, sc, bi, s0, eps=eps))
    monkeypatch.setattr(wkv_fused, "wkv6_fused_output_bwd", wkv6_fused_output_bwd_plain)


def test_autograd_functions_give_the_plain_gradients(monkeypatch):
    _swap_kernels_for_plain(monkeypatch)
    rng = np.random.default_rng(7)
    p_args = _t(*_prologue_inputs(rng, 2, 9, 64, 8), grad=True)
    outs = ddlerp._TmixPrologue.apply(*p_args, 1e-5)
    loss = sum((o * (i + 1)).sum() for i, o in enumerate(outs[:5]))   # xln unused
    got = torch.autograd.grad(loss, p_args)
    outs = tmix_prologue_plain(*p_args)
    want = torch.autograd.grad(sum((o * (i + 1)).sum() for i, o in enumerate(outs[:5])), p_args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)

    r, k, v, w, u, g, sc, bi, s0 = _wkv_inputs(rng, 2, 6, 2, 32)
    w_args = _t(r, k, v, w, u, g, sc, bi, s0[0], grad=True)   # (H, N, N) initial state
    out, sT = wkv_fused._WkvFused.apply(*w_args, 1e-3)
    got = torch.autograd.grad((out * 2).sum(), w_args)        # sT unused: dsT is None
    out, sT = wkv6_fused_output_plain(*w_args, eps=1e-3)
    want = torch.autograd.grad((out * 2).sum(), w_args)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    x = torch.tensor(rng.normal(size=(3, 64)).astype(np.float32), requires_grad=True)
    sc_, bi_ = _t(rng.normal(1, 0.1, size=64).astype(np.float32), np.zeros(64, np.float32))
    (gx,) = torch.autograd.grad((ln._LayerNorm.apply(x, sc_, bi_, 1e-5) ** 2).sum(), [x])
    (wx,) = torch.autograd.grad((layer_norm_plain(x, sc_, bi_) ** 2).sum(), [x])
    torch.testing.assert_close(gx, wx, rtol=0, atol=0)


def test_wrappers_without_a_backward_refuse_grad_off_the_cpu():
    """B.4 has no backward: off the CPU, an input that requires grad raises
    (before any launch) instead of detaching the graph. B.9's backward is a
    recompute from the saved inputs, so only its in-place form refuses grad;
    the out-of-place form goes on to the device checks."""
    before = launch_counts()
    x = torch.empty(4, 64, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        quantize_rows(x)
    r = torch.empty(1, 64, device="meta", requires_grad=True)
    state = torch.empty(1, 2, 32, 32, device="meta")
    meta = lambda *shape: torch.empty(*shape, device="meta")
    args = (r, r, r, r, r, meta(2, 32), meta(64), meta(64), state)
    with pytest.raises(RuntimeError, match="in-place"):
        wkv6_decode_step(*args, eps=1e-3, out_state=state)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_decode_step(*args, eps=1e-3)
    with torch.no_grad(), pytest.raises(ValueError):      # no grad: on to the device checks
        quantize_rows(x)
    assert launch_counts() == before
