"""Gradients of the RWKV-4 recurrence, the RWKV-4 and RWKV-5.0 models and the
legacy options (CPU, the kernels' plain versions) against ``jax.grad`` of the
JAX package.

B.14's backward: its plain version (autograd through ``wkv4_plain``) and the
backward kernel's own algorithm on CPU tensors (``wkv4_backward_plain``, a
helper of this file that walks csrc/wkv4.cu ``wkv4_bwd_kernel`` in torch: the
chunk-entry states, each chunk recomputed, the adjoint of every step) against
``jax.grad`` of JAX's ``wkv4`` scan: dk, dv, dw, du and the initial state's
gradient, under incoming gradients of y and of the final state, within 1e-5
of max|JAX| in fp32. The inputs cover a fresh state (pp = -1e38), a carried
nonzero one, k up to 60 and T in {1, 17, 37} (chunks of 16: one partial, two
and a ragged third).

The models: JAX's RWKV-4 test model (tests/test_rwkv4.py), with the gradient
of a loss over two chained calls (the state of the first carried into the
second with its gradient, as TBPTT carries it); the v5.0 model of
tests/test_torch_family_train.py; and one model per legacy option group
(tests/test_torch_model_options.py: head_qk, tiny attention, MishGLU,
pre_ffn, my_pos_emb, v5.2 with pre_ffn and MishGLU). Each loss is sum(logits
x a fixed cotangent); every parameter's gradient within 1e-5 of its largest
value, 5e-4 for the option models: on the head_qk and tiny-attention ones
(q k^T over weights filled at 0.3) the JAX package's own two WKV routes,
reference and auto, give gradients 1.3e-4 and 1.5e-4 of max apart (measured
on this file's inputs; 1.6e-5 on MishGLU), and the port sits at most 1.2e-4
from the reference route.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.models.rwkv4 import rwkv4_forward as jax_rwkv4_forward
from rwkv_lm_ext_tpu.ops.wkv4 import wkv4 as jax_wkv4
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    checkpoint_config,
    load_state_dict_into,
    state_dict_from_jax_tree,
)
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.ops.wkv4 import CHUNK, _state_step, init_wkv4_state, wkv4
from tests.test_rwkv4 import CFG as JAX_V4_CFG
from tests.test_rwkv4 import _v4_params
from tests.test_torch_family_train import family_params
from tests.test_torch_model_options import OPTIONS, jax_option_params, port_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers


def assert_close(got, want, what, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _max_share(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The share of d max(a, b) that goes to a: 1 where a is the max, 0.5 on
    a tie (jnp.maximum's and torch.maximum's rule)."""
    return (a > b).float() + 0.5 * (a == b).float()


@torch.no_grad()
def wkv4_backward_plain(
    k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
    state, gy: torch.Tensor, g_state=None,
    *, chunk: int = CHUNK,
):
    """The backward kernel's algorithm (csrc/wkv4.cu ``wkv4_bwd_kernel``) in
    torch ops: the forward's state at every chunk's entry, then chunk by chunk
    in reverse the chunk's states again and the adjoint of each step, in the
    kernel's order. k, v (B, T, C); w, u (C,); state the initial (aa, bb, pp)
    or None; gy (B, T, C); g_state the gradient of the final state or None.
    Returns (dk, dv (B, T, C) fp32, dw, du (C,), (daa, dbb, dpp) of the
    initial state)."""
    B, T, C = k.shape
    kf, vf, gyf = k.float(), v.float(), gy.float()
    wf, uf = w.float(), u.float()
    aa, bb, pp = init_wkv4_state(B, C, k.device) if state is None else (s.float() for s in state)
    entries = []
    for t in range(T):
        if t % chunk == 0:
            entries.append((aa, bb, pp))
        aa, bb, pp = _state_step(aa, bb, pp, kf[:, t], vf[:, t], wf)
    zero = torch.zeros(B, C, dtype=torch.float32, device=k.device)
    ga, gb, gp = (zero, zero, zero) if g_state is None else (g.float() for g in g_state)
    gk, gv = torch.zeros_like(kf), torch.zeros_like(vf)
    gw_rows, gu_rows = zero.clone(), zero.clone()
    for ci in reversed(range(len(entries))):
        t0 = ci * chunk
        states = []
        aa, bb, pp = entries[ci]
        for t in range(t0, min(t0 + chunk, T)):
            states.append((aa, bb, pp))
            aa, bb, pp = _state_step(aa, bb, pp, kf[:, t], vf[:, t], wf)
        for t in reversed(range(t0, min(t0 + chunk, T))):
            a, bq, q = states[t - t0]
            kk, vv = kf[:, t], vf[:, t]
            ww1 = uf + kk
            p1 = torch.maximum(q, ww1)
            e1, e2 = torch.exp(q - p1), torch.exp(ww1 - p1)
            den = e1 * bq + e2
            y = (e1 * a + e2 * vv) / den
            gnum = gyf[:, t] / den
            gden = -gnum * y
            ge1, ge2 = gnum * a + gden * bq, gnum * vv + gden
            ww2 = q + wf
            p2 = torch.maximum(ww2, kk)
            f1, f2 = torch.exp(ww2 - p2), torch.exp(kk - p2)
            gf1, gf2 = ga * a + gb * bq, ga * vv + gb
            gv[:, t] = gnum * e2 + ga * f2
            ga_prev, gb_prev = gnum * e1 + ga * f1, gden * e1 + gb * f1
            gp1 = -ge1 * e1 - ge2 * e2
            s1 = _max_share(q, ww1)
            gww1 = ge2 * e2 + gp1 * (1 - s1)
            gq = ge1 * e1 + gp1 * s1
            gp2 = gp - gf1 * f1 - gf2 * f2
            s2 = _max_share(ww2, kk)
            gww2 = gf1 * f1 + gp2 * s2
            gk[:, t] = gww1 + gf2 * f2 + gp2 * (1 - s2)
            gq = gq + gww2
            gu_rows = gu_rows + gww1
            gw_rows = gw_rows + gww2
            ga, gb, gp = ga_prev, gb_prev, gq
    return gk, gv, gw_rows.sum(0), gu_rows.sum(0), (ga, gb, gp)


def wkv_case(T, seed, carried):
    rng = np.random.default_rng(seed)
    B, C = 2, 24
    k = rng.uniform(-3.0, 60.0, size=(B, T, C)).astype(np.float32)
    v = rng.normal(size=(B, T, C)).astype(np.float32)
    w = -np.exp(rng.normal(size=C)).astype(np.float32)
    u = rng.normal(size=C).astype(np.float32)
    if carried:
        s = (rng.normal(size=(B, C)).astype(np.float32),
             np.exp(rng.normal(size=(B, C))).astype(np.float32),
             rng.uniform(-5, 5, size=(B, C)).astype(np.float32))
    else:
        s = (np.zeros((B, C), np.float32), np.zeros((B, C), np.float32),
             np.full((B, C), -1e38, np.float32))
    gy = rng.normal(size=(B, T, C)).astype(np.float32)
    gs = tuple(rng.normal(size=(B, C)).astype(np.float32) for _ in range(3))
    return (k, v, w, u, s), gy, gs


@pytest.mark.parametrize("T,carried", [(1, False), (1, True), (17, False), (17, True),
                                       (37, False), (37, True)])
def test_wkv4_backward_matches_jax_grad(T, carried):
    (k, v, w, u, s), gy, gs = wkv_case(T, seed=T + carried, carried=carried)

    def jax_loss(k, v, w, u, s):
        y, fs = jax_wkv4(k, v, w, u, s)
        return jnp.sum(y * gy) + sum(jnp.sum(a * b) for a, b in zip(fs, gs))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (k, v, w, u)), tuple(map(jnp.asarray, s)))
    want = list(want[:4]) + list(want[4])
    # autograd through the plain version (what a CPU tensor runs)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (k, v, w, u, *s)]
    y, fs = wkv4(*leaves[:4], tuple(leaves[4:]))
    ((y * torch.from_numpy(gy)).sum() + sum((a * torch.from_numpy(b)).sum()
                                            for a, b in zip(fs, gs))).backward()
    # the backward kernel's algorithm
    gk, gv, gw, gu, g0 = wkv4_backward_plain(
        *map(torch.from_numpy, (k, v, w, u)), tuple(map(torch.from_numpy, s)),
        torch.from_numpy(gy), tuple(map(torch.from_numpy, gs)))
    names = ("dk", "dv", "dw", "du", "daa", "dbb", "dpp")
    for name, a, b, jw in zip(names, [x.grad for x in leaves], (gk, gv, gw, gu, *g0), want):
        jw = np.asarray(jw)
        assert np.isfinite(b.numpy()).all(), name
        if np.abs(jw).max() == 0:      # a fresh state: no gradient reaches it
            assert not a.any() and not b.any(), name
            continue
        assert_close(a, jw, f"autograd {name}")
        assert_close(b, jw, f"kernel algorithm {name}")


def _grads_vs_jax(model, flat_grads, rel):
    for name, p in model.named_parameters():
        g = np.asarray(flat_grads[name], np.float32).reshape(p.shape)
        got = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        assert np.abs(got - g).max() <= rel * max(np.abs(g).max(), 1e-30), name


def test_v4_model_gradient_through_a_carried_state_matches_jax():
    """Two calls of 5 and 7 tokens, the state between them carried with its
    gradient (TBPTT's chain)."""
    jcfg = JAX_V4_CFG
    params = _v4_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(8).integers(0, 100, size=(2, 12))
    cot = np.random.default_rng(9).normal(size=(2, 12, 100)).astype(np.float32)

    def jax_loss(p):
        a, st = jax_rwkv4_forward(p, jcfg, jnp.asarray(tokens[:, :5]))
        b, _ = jax_rwkv4_forward(p, jcfg, jnp.asarray(tokens[:, 5:]), st)
        return jnp.sum(jnp.concatenate([a, b], 1) * cot)

    jgrads = jax.grad(jax_loss)(params)
    sd = jax_params_to_state_dict(params, jcfg)
    model = load_state_dict_into(RWKV(checkpoint_config(sd, dtype="float32"), device="cpu"), sd)
    a, st = model(torch.from_numpy(tokens[:, :5]), t1_step=False)
    b, _ = model(torch.from_numpy(tokens[:, 5:]), st, remat=True)
    (torch.cat([a, b], 1) * torch.from_numpy(cot)).sum().backward()
    _grads_vs_jax(model, jax_params_to_state_dict(jgrads, jcfg), 1e-5)


def test_v5_0_model_gradient_matches_jax():
    params, jcfg = family_params("v5.0")
    tokens = np.random.default_rng(10).integers(3, 1000, size=(2, 10))
    cot = np.random.default_rng(11).normal(size=(2, 10, 1000)).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jax_rwkv_forward(
        p, jcfg, jnp.asarray(tokens), wkv_backend="reference")[0] * cot))(params)
    sd = jax_params_to_state_dict(params, jcfg)
    model = load_state_dict_into(RWKV(checkpoint_config(sd, dtype="float32"), device="cpu"), sd)
    assert model.cfg.version == 5.0 and model.blocks[0].att.gate is None
    logits, _ = model(torch.from_numpy(tokens))
    (logits * torch.from_numpy(cot)).sum().backward()
    # both packages broadcast the checkpoint's per-head (H,) decay to (H, N)
    # on load, so the decay's gradient is (H, N) on either side
    _grads_vs_jax(model, jax_params_to_state_dict(jgrads, jcfg), 1e-5)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_legacy_option_gradient_matches_jax(name):
    options = OPTIONS[name]
    params, jcfg = jax_option_params(options)
    tokens = np.random.default_rng(12).integers(4, 100, size=(2, 10))
    cot = np.random.default_rng(13).normal(size=(2, 10, 100)).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jax_rwkv_forward(
        p, jcfg, jnp.asarray(tokens), wkv_backend="reference")[0] * cot))(params)
    model = port_model(params, options)
    logits, _ = model(torch.from_numpy(tokens))
    (logits * torch.from_numpy(cot)).sum().backward()
    _grads_vs_jax(model, state_dict_from_jax_tree(jgrads, model.cfg), 5e-4)
