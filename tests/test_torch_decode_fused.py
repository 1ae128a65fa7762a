"""The port's fused T=1 decode route (CPU, plain versions) vs the JAX package.

Tolerances, as tests/test_decode_fused.py holds the Pallas kernels against
their jnp compositions: the prologues 2e-5 in fp32 (the kernel's variance is
E[x^2] - mu^2, the composition's is var), the whole channel-mix block 3e-5,
bf16 atol=1e-4 / rtol=1e-2 (one ulp at rounding ties); the model step 3e-4 on
logits and on all three state parts; the transposed decode step 2e-4, as the
packed one in tests/test_torch_decode.py. Gradients of the recompute backward
1e-4 of the largest value (fp32, another summation order).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.adapters.quant import quantize_tree
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.decode import rwkv_decode_step as jax_rwkv_decode_step
from rwkv_lm_ext_tpu.models.rwkv import as_weight
from rwkv_lm_ext_tpu.models.state import init_model_state as jax_init_model_state
from rwkv_lm_ext_tpu.ops import decode_fused as jdf
from rwkv_lm_ext_tpu.ops.wkv_decode import (
    _decode_ref,
    _pick_bt_packed,
    wkv6_decode_step_packed_pallas,
)
from rwkv_lm_ext_tpu.models.state import pack_wkv
from rwkv_lm_ext_tpu_torch.adapters.quant import QuantLinear, quantize_model
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, PLAIN_OPS, RWKV
from rwkv_lm_ext_tpu_torch.models.state import state_from_jax
from rwkv_lm_ext_tpu_torch.ops import _lib, launch_counts
from rwkv_lm_ext_tpu_torch.ops.decode_fused import (
    att_prep_fused,
    att_prep_plain,
    ffn_block_fused,
    ffn_block_plain,
    ffn_prep_fused,
    ffn_prep_plain,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import (
    transpose_state,
    wkv6_decode_step,
    wkv6_decode_step_plain,
    wkv6_decode_step_transposed,
    wkv6_decode_step_transposed_plain,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = pathlib.Path(__file__).resolve().parent.parent
EPS = 1e-5
LN_X_EPS = 6.4e-4
TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=1e-4, rtol=1e-2)}
BLOCK_TOL = {"float32": dict(atol=3e-5, rtol=3e-5), "bfloat16": dict(atol=1e-4, rtol=1e-2)}


def _att_inputs(seed, B, C=256, D=8, Dd=16):
    rng = np.random.default_rng(seed)
    mk = lambda *sh, s=1.0: (rng.normal(size=sh) * s).astype(np.float32)
    return [mk(B, C), mk(B, C), 1.0 + 0.1 * mk(C), 0.1 * mk(C), mk(6, C, s=0.5),
            mk(C, 5 * D, s=0.2), mk(5, D, C, s=0.2), mk(C, Dd, s=0.2), mk(Dd, C, s=0.2), mk(C)]


def _ffn_inputs(seed, B, C, F=None):
    rng = np.random.default_rng(seed)
    mk = lambda *sh, s=1.0: (rng.normal(size=sh) * s).astype(np.float32)
    args = [mk(B, C), mk(B, C), 1.0 + 0.1 * mk(C), 0.1 * mk(C),
            rng.uniform(size=C).astype(np.float32), rng.uniform(size=C).astype(np.float32)]
    if F is not None:      # JAX layout (in, out)
        args += [mk(C, F, s=0.05), mk(F, C, s=0.05), mk(C, C, s=0.05)]
    return args


def _j(args, dtype):
    """numpy inputs as JAX arrays, the activations x in ``dtype``."""
    return [jnp.asarray(args[0]).astype(dtype)] + [jnp.asarray(a) for a in args[1:]]


def _t(args, dtype, transpose=()):
    """The same inputs as torch tensors; ``transpose`` names the weights the
    port holds in (out, in) layout."""
    out = [torch.from_numpy(a.T.copy() if i in transpose else a) for i, a in enumerate(args)]
    out[0] = out[0].to(getattr(torch, dtype))
    return out


def _assert_all_close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [16, 6, 1])
def test_att_prep_matches_jax(B, dtype):
    """B=16 reaches the Pallas kernel (interpret mode); 6 and 1 are rows the
    TPU wrapper hands to its jnp composition and the port's kernel takes."""
    args = _att_inputs(B, B)
    jargs = _j(args, dtype)
    got = att_prep_fused(*_t(args, dtype), EPS)
    assert [g.dtype for g in got] == [getattr(torch, dtype)] * 4 + [torch.float32] * 2
    _assert_all_close(got, jdf.att_prep_fused(*jargs, EPS, interpret=True), TOL[dtype])
    _assert_all_close(got, jdf._att_prep_ref(*jargs, EPS), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [16, 6, 1])
def test_ffn_prep_matches_jax(B, dtype):
    args = _ffn_inputs(10 + B, B, 256)
    jargs = _j(args, dtype)
    got = ffn_prep_fused(*_t(args, dtype), EPS)
    _assert_all_close(got, jdf.ffn_prep_fused(*jargs, EPS, interpret=True), TOL[dtype])
    _assert_all_close(got, jdf._ffn_prep_ref(*jargs, EPS), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [16, 6, 1])
def test_ffn_block_matches_jax(B, dtype):
    """C=512, F=1024: the smallest widths at which the TPU wrapper reaches its
    kernel (B=16); the port holds the weights transposed."""
    args = _ffn_inputs(20 + B, B, 512, 1024)
    jargs = _j(args, dtype)
    jargs[6:] = [w.astype(dtype) for w in jargs[6:]]
    targs = _t(args, dtype, transpose=(6, 7, 8))
    targs[6:] = [w.to(getattr(torch, dtype)) for w in targs[6:]]
    got = ffn_block_fused(*targs, EPS)
    _assert_all_close(got, jdf.ffn_block_fused(*jargs, EPS, interpret=True), BLOCK_TOL[dtype])
    _assert_all_close(got, jdf._ffn_block_ref(*jargs, EPS), BLOCK_TOL[dtype])


def _loss_torch(outs):
    return sum((o.float() ** 2).sum() for o in outs)


def _loss_jax(outs):
    return sum(jnp.sum(o.astype(jnp.float32) ** 2) for o in outs)


GRAD_CASES = {
    "att_prep": (att_prep_plain, jdf.att_prep_fused, lambda: _att_inputs(30, 8, 128, 8, 8), ()),
    "ffn_prep": (ffn_prep_plain, jdf.ffn_prep_fused, lambda: _ffn_inputs(31, 8, 128), ()),
    "ffn_block": (ffn_block_plain, jdf.ffn_block_fused, lambda: _ffn_inputs(32, 8, 512, 1024),
                  (6, 7, 8)),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_recompute_backward_matches_jax_grad(name):
    """The autograd route the CUDA wrappers take under grad (forward by the
    launch, backward by a recompute through the plain version), driven here
    with the plain version as the launch, against jax.grad through the
    custom_vjp of the Pallas wrapper."""
    plain, jax_fn, make, transpose = GRAD_CASES[name]
    args = make()
    targs = [t.requires_grad_() for t in _t(args, "float32", transpose)]
    outs = _lib.recompute_backward(plain, plain, tuple(targs), eps=EPS)
    assert all(o.grad_fn is not None for o in outs)
    _loss_torch(outs).backward()
    want = jax.grad(lambda *a: _loss_jax(jax_fn(*a, EPS, True)), argnums=tuple(range(len(args))))(
        *_j(args, "float32"))
    for i, (t, w) in enumerate(zip(targs, want)):
        w = np.asarray(w).T if i in transpose else np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_recompute_backward_skips_missing_cotangents_and_frozen_inputs():
    args = _t(_ffn_inputs(33, 4, 64), "float32")
    args[0].requires_grad_()
    xk, xr, xn = _lib.recompute_backward(ffn_prep_plain, ffn_prep_plain, tuple(args), eps=EPS)
    xr.sum().backward()                     # xk and xn get no cotangent
    ref = args[0].detach().clone().requires_grad_()
    ffn_prep_plain(ref, *args[1:], EPS)[1].sum().backward()
    np.testing.assert_allclose(args[0].grad.numpy(), ref.grad.numpy(), rtol=1e-6, atol=1e-7)
    assert all(a.grad is None for a in args[1:])


# ------------------------------------------------------------ the model step


def _jax_model(seed=0):
    """The 2-layer C=64 model of tests/test_decode_fused.py, with the
    projections that init zeroes filled so that every block contributes."""
    cfg = JaxModelConfig(n_layer=2, n_embd=64, vocab_size=97, head_size=16,
                         dtype="float32", param_dtype="float32")
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), cfg, fast_init=True)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    return cfg, params


def _port_model(params, jcfg):
    sd = jax_params_to_state_dict(params, jcfg)
    return load_state_dict_into(RWKV(sniff_model_config(sd, dtype="float32"), device="cpu"), sd)


def _seeded_state(cfg, B, seed=2):
    state = jax_init_model_state(cfg, B)
    rng = np.random.default_rng(seed)
    return {k: v + jnp.asarray(0.01 * rng.normal(size=v.shape), v.dtype) for k, v in state.items()}


def test_maas_stack_matches_jax():
    """The (6, C) fp32 array ``_att_step_fused`` stacks from the JAX leaves
    (models/decode.py:78-83) is the port's ``TimeMix._maas()``."""
    cfg, params = _jax_model()
    model = _port_model(params, cfg)
    for bp, block in zip(params["blocks"], model.blocks):
        want = jnp.stack([as_weight(bp["att"][k], jnp.float32) for k in (
            "time_maa_x", "time_maa_w", "time_maa_k", "time_maa_v", "time_maa_r", "time_maa_g")])
        got = block.att._maas()
        assert got.shape == (6, cfg.n_embd) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("quant", [None, "int8"])
def test_rwkv_decode_step_fused_matches_jax(quant):
    """rwkv_decode_step(fused_prep=True) against the JAX fused step (Pallas
    kernels in interpret mode) from the same seeded state: dense leaves take
    the whole-block kernel on both sides, int8 leaves the prologue kernel and
    their own projections."""
    cfg, params = _jax_model()
    model = _port_model(params, cfg)
    if quant:
        params = quantize_tree(params, quant)
        quantize_model(model, quant)
        assert isinstance(model.blocks[0].ffn.key, QuantLinear)
    B = 8
    tokens = np.random.default_rng(1).integers(0, 97, size=(B,))
    jstate = _seeded_state(cfg, B)
    want_logits, want_state = jax_rwkv_decode_step(params, cfg, jnp.asarray(tokens), jstate,
                                                   fused_prep=True)
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             state_from_jax({k: np.asarray(v) for k, v in jstate.items()}, 16).items()}
    calls = []
    ops = PLAIN_OPS._replace(**{
        name: (lambda *a, _n=name, _f=getattr(PLAIN_OPS, name), **kw: (calls.append(_n), _f(*a, **kw))[1])
        for name in ("att_prep", "ffn_prep", "ffn_block", "tmix_prologue")})
    with torch.no_grad():
        logits, new_state = rwkv_decode_step(model, torch.from_numpy(tokens), state, fused_prep=True)
        x = model.embed(torch.from_numpy(tokens)[:, None])
        scratch = {k: torch.empty_like(v) for k, v in state.items()}
        for i, block in enumerate(model.blocks):
            x = block.step(x, state, scratch, i, ops, True)
    # the branch the leaves pick: B.12 for dense, B.11 for quantized; never K2
    assert calls == ["att_prep", "ffn_prep" if quant else "ffn_block"] * 2
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), atol=3e-4, rtol=3e-4)
    want_state = state_from_jax({k: np.asarray(v) for k, v in want_state.items()}, 16)
    for key in ("att_shift", "wkv", "ffn_shift"):
        np.testing.assert_allclose(new_state[key].numpy(), want_state[key], atol=3e-4, rtol=3e-4)
        np.testing.assert_allclose(scratch[key].numpy(), want_state[key], atol=3e-4, rtol=3e-4)


def test_rwkv_decode_step_fused_default_off_and_in_place():
    """The default is the unfused route (None -> False, as in JAX); the two
    routes agree in fp32; out=state reads every slice before writing it."""
    cfg, params = _jax_model(seed=3)
    model = _port_model(params, cfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 97, size=(5,)))
    state = {k: torch.from_numpy(np.array(v)) for k, v in state_from_jax(
        {k: np.asarray(v) for k, v in _seeded_state(cfg, 5).items()}, 16).items()}
    with torch.no_grad():
        default, s_default = rwkv_decode_step(model, tokens, state)
        unfused, s_unfused = rwkv_decode_step(model, tokens, state, fused_prep=False)
        fused, s_fused = rwkv_decode_step(model, tokens, state, fused_prep=True)
        assert torch.equal(default, unfused)
        assert all(torch.equal(s_default[k], s_unfused[k]) for k in state)
        np.testing.assert_allclose(fused.numpy(), unfused.numpy(), atol=3e-4, rtol=3e-4)
        inplace = {k: v.clone() for k, v in state.items()}
        again, out = rwkv_decode_step(model, tokens, inplace, out=inplace, fused_prep=True)
    assert out is inplace and torch.equal(again, fused)
    for key in state:
        np.testing.assert_allclose(s_fused[key].numpy(), s_unfused[key].numpy(), atol=3e-4, rtol=3e-4)
        assert torch.equal(inplace[key], s_fused[key])


def test_ops_tables_hold_the_fused_entries():
    assert KERNEL_OPS.att_prep is att_prep_fused and PLAIN_OPS.att_prep is att_prep_plain
    assert KERNEL_OPS.ffn_prep is ffn_prep_fused and PLAIN_OPS.ffn_prep is ffn_prep_plain
    assert KERNEL_OPS.ffn_block is ffn_block_fused and PLAIN_OPS.ffn_block is ffn_block_plain
    assert {"att_prep_fused", "ffn_prep_fused", "ffn_block_fused",
            "wkv6_decode_step_transposed"} <= set(launch_counts())


# ------------------------------------------------- B.13 and B.9's backward


def _decode_inputs(rng, B, H, N):
    C = H * N
    mk = lambda *sh: rng.normal(size=sh).astype(np.float32)
    return dict(
        r=mk(B, C), k=mk(B, C), v=mk(B, C),
        w=rng.uniform(-8, 2.5, size=(B, C)).astype(np.float32),
        g=mk(B, C), u=mk(H, N) * 0.5, ln_scale=1 + 0.1 * mk(C), ln_bias=0.1 * mk(C),
        state=mk(B, H, N, N) * 0.3,
    )


ORDER = ("r", "k", "v", "w", "g", "u", "ln_scale", "ln_bias")


def _bench_script():
    """scripts/bench_decode_transposed.py as a module (its main is guarded)."""
    spec = importlib.util.spec_from_file_location(
        "bench_decode_transposed", REPO / "scripts" / "bench_decode_transposed.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_transposed_decode_step_matches_the_pallas_experiment():
    B, H, N = 4, 2, 64
    assert _pick_bt_packed(B, H, N) is not None          # reaches pallas_call
    bench = _bench_script()
    a = _decode_inputs(np.random.default_rng(5), B, H, N)
    ja = [jnp.asarray(a[k]) for k in ORDER]
    s_log = jnp.asarray(a["state"])
    want_out, want_sT = bench.decode_step_transT(*ja, bench.pack_T(s_log), LN_X_EPS, interpret=True)
    ref_out, ref_s = _decode_ref(*(x.reshape(B, H, N) for x in ja[:5]), *ja[5:], s_log, LN_X_EPS)
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    state_t = transpose_state(ta.pop("state"))
    # the port's transposed layout is the script's, before its 128-lane packing
    np.testing.assert_array_equal(state_t.numpy().reshape(B, H, -1, 128),
                                  np.asarray(bench.pack_T(s_log)))
    got_out, got_sT = wkv6_decode_step_transposed(**ta, state_t=state_t, eps=LN_X_EPS)
    assert got_sT.is_contiguous() and got_sT.shape == (B, H, N, N)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), **tol)
    np.testing.assert_allclose(got_sT.numpy(), np.asarray(want_sT).reshape(B, H, N, N), **tol)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out), **tol)
    np.testing.assert_allclose(transpose_state(got_sT).numpy(), np.asarray(ref_s), **tol)
    np.testing.assert_allclose(np.asarray(bench.unpack_T(want_sT, N)), np.asarray(ref_s), **tol)


def test_transposed_decode_step_is_the_logical_step_and_updates_in_place():
    B, H, N = 3, 2, 32
    a = {k: torch.from_numpy(v) for k, v in _decode_inputs(np.random.default_rng(6), B, H, N).items()}
    out, snew = wkv6_decode_step_plain(**a, eps=LN_X_EPS)
    state = a.pop("state")
    state_t = transpose_state(state)
    assert state_t.is_contiguous() and torch.equal(state_t, state.transpose(-1, -2))
    assert torch.equal(transpose_state(state_t), state)          # its own inverse
    buf = state_t.clone()
    out_t, s_t = wkv6_decode_step_transposed_plain(**a, state_t=buf, eps=LN_X_EPS, out_state=buf)
    assert s_t.data_ptr() == buf.data_ptr()
    assert torch.equal(transpose_state(buf), snew)           # elementwise: the same bits
    # y sums over the strided axis of the view: another order, fp32 rounding only
    np.testing.assert_allclose(out_t.numpy(), out.numpy(), rtol=0, atol=1e-6 * float(out.abs().max()))


def test_decode_step_backward_matches_jax_custom_vjp():
    """B.9 under grad: the recompute backward (here with the plain version
    as the launch) against jax.grad through the Pallas decode kernel, whose
    custom_vjp recomputes through the XLA composition."""
    B, H, N = 4, 2, 64
    a = _decode_inputs(np.random.default_rng(7), B, H, N)
    rng = np.random.default_rng(8)
    ct_out = rng.normal(size=(B, H * N)).astype(np.float32)
    ct_state = rng.normal(size=(B, H, N, N)).astype(np.float32)

    def jloss(*args):
        out, s = wkv6_decode_step_packed_pallas(*args[:8], pack_wkv(args[8]), LN_X_EPS, True)
        return jnp.sum(out * ct_out) + jnp.sum(s * pack_wkv(jnp.asarray(ct_state)))

    names = ORDER + ("state",)
    want = jax.grad(jloss, argnums=tuple(range(9)))(*(jnp.asarray(a[k]) for k in names))
    leaves = [torch.from_numpy(a[k]).requires_grad_() for k in names]
    launch = lambda *t, eps: wkv6_decode_step_plain(*t, eps=eps)
    out, s = _lib.recompute_backward(launch, wkv6_decode_step_plain, tuple(leaves), eps=LN_X_EPS)
    ((out * torch.from_numpy(ct_out)).sum() + (s * torch.from_numpy(ct_state)).sum()).backward()
    for name, t, w in zip(names, leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w.reshape(t.shape), rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    # the public wrapper differentiates on the CPU too (through its plain version)
    r = torch.from_numpy(a["r"]).requires_grad_()
    o, _ = wkv6_decode_step(r, *(torch.from_numpy(a[k]) for k in names[1:]), eps=LN_X_EPS)
    (o * torch.from_numpy(ct_out)).sum().backward()
    assert r.grad is not None and bool(torch.isfinite(r.grad).all())


def test_fused_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """Neither a CPU nor a CUDA tensor: the wrappers raise instead of running
    the plain version, and the widths the kernels need are checked first."""
    before = launch_counts()
    meta = lambda *s: torch.empty(*s, device="meta")
    C = 64
    vec = [meta(C)] * 2
    with pytest.raises(ValueError, match="CUDA"):
        ffn_prep_fused(meta(2, C), meta(2, C), *vec, meta(C), meta(C))
    with pytest.raises(ValueError, match="multiples of 8"):
        att_prep_fused(meta(2, C), meta(2, C), *vec, meta(6, C), meta(C, 20), meta(5, 4, C),
                       meta(C, 8), meta(8, C), meta(C))
    with pytest.raises(ValueError, match="multiples of 32"):
        ffn_block_fused(meta(2, 48), meta(2, 48), meta(48), meta(48), meta(48), meta(48),
                        meta(96, 48), meta(48, 96), meta(48, 48))
    with pytest.raises(ValueError, match="out, in"):
        ffn_block_fused(meta(2, C), meta(2, C), *vec, meta(C), meta(C),
                        meta(C, 128), meta(128, C), meta(C, C))
    with pytest.raises(ValueError):
        wkv6_decode_step_transposed(*(meta(2, 128),) * 5, torch.ones(2, 64), torch.ones(128),
                                    torch.zeros(128), meta(2, 2, 64, 64), eps=LN_X_EPS)
    assert launch_counts() == before


def test_fused_step_refuses_dim_att_other_than_n_embd_by_name():
    """The fused attention prologue makes the decay over n_embd channels (as
    the JAX kernel does), so a model with dim_att != n_embd is refused by
    name on the fused route, before any shape check inside the op, and still
    runs on the unfused route."""
    from rwkv_lm_ext_tpu_torch.config import ModelConfig
    from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params

    cfg = ModelConfig(n_layer=1, n_embd=64, dim_att=32, vocab_size=97, head_size=16,
                      dtype="float32", param_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    model = load_state_dict_into(RWKV(cfg, device="cpu"), init_rwkv_params(cfg, generator=gen, device="cpu"))
    tokens = torch.tensor([3, 5])
    with torch.no_grad():
        with pytest.raises(ValueError, match="dim_att == n_embd.*dim_att=32, n_embd=64"):
            rwkv_decode_step(model, tokens, fused_prep=True)
        logits, _ = rwkv_decode_step(model, tokens, fused_prep=False)
    assert logits.shape == (2, 97) and bool(torch.isfinite(logits).all())

