"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the edge shapes the main path does not reach: ragged T and C, T=1, both
head sizes, fp32 as well as bf16, and no initial state. The plain version runs
in fp32 on the same (dtype-rounded) inputs, except the int8 row quantizer,
which is held bit-equal to its plain version on the same input.

These tests need an NVIDIA GPU and skip elsewhere. The GPU machine has no
JAX, so run them there without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerances: out <= REL[dtype] * max|plain| (fp32: summation order only;
bf16: one rounding of each output), the WKV state <= 1e-4 * max|plain|
(fp32 in both). Backward kernels, each gradient against autograd through
the plain version: B.5 <= 5e-4 (fp32) / 2e-2 (bf16) * max|plain|, B.6 + B.7
<= 1e-4 / 2e-2; model gradients (kernel route vs plain route, fp32) <=
1e-3 * max|plain|. Two calls of a backward kernel are bit-equal.
"""
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu_torch.adapters.lora import LoraConfig, apply_lora, init_lora_params
from rwkv_lm_ext_tpu_torch.adapters.quant import int8_product, quantize_model
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.ops import launch_counts
from rwkv_lm_ext_tpu_torch.ops.ddlerp import (
    tmix_prologue,
    tmix_prologue_bwd,
    tmix_prologue_bwd_plain,
    tmix_prologue_plain,
)
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows, quantize_rows_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import wkv6_decode_step, wkv6_decode_step_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    wkv6_fused_output,
    wkv6_fused_output_bwd,
    wkv6_fused_output_bwd_plain,
    wkv6_fused_output_plain,
)
from rwkv_lm_ext_tpu_torch.train.losses import causal_lm_loss

pytestmark = pytest.mark.cuda

REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]
NO_LAUNCH = {"layer_norm": 0, "tmix_prologue": 0, "wkv6_fused_output": 0, "wkv6_decode_step": 0,
             "quantize_rows": 0, "tmix_prologue_bwd": 0, "wkv6_bwd_forward_pass": 0,
             "wkv6_bwd_reverse_pass": 0}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, dtype, rng, *shape, scale=1.0, loc=0.0):
    a = rng.normal(loc, scale, size=shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


def _close(got, want, rel, name="", scale=None):
    """max|got - want| <= rel * scale, scale = max|want| unless given."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item() if scale is None else scale
    assert err <= rel * scale, (name, err, scale)


def _counted(name, fn):
    before = launch_counts()[name]
    out = fn()
    assert launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 37, 2050), (1, 1, 7)])
def test_layer_norm_kernel(dev, dtype, shape):
    rng = np.random.default_rng(0)
    C = shape[-1]
    x = _on(dev, dtype, rng, *shape, scale=3.0, loc=1.0)
    sc, bi = _on(dev, dtype, rng, C, scale=0.2, loc=1.0), _on(dev, dtype, rng, C, scale=0.2)
    got = _counted("layer_norm", lambda: layer_norm(x, sc, bi))
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, layer_norm_plain(x.float(), sc.float(), bi.float()), REL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,C,D", [(3, 37, 2050, 32), (2, 1, 256, 64), (1, 9, 4096, 64)])
def test_tmix_prologue_kernel(dev, dtype, B, T, C, D):
    rng = np.random.default_rng(1)
    args = (
        _on(dev, dtype, rng, B, T, C), _on(dev, dtype, rng, B, C),   # non-zero shift
        _on(dev, dtype, rng, C, scale=0.2, loc=1.0), _on(dev, dtype, rng, C, scale=0.2),
        torch.from_numpy(rng.uniform(0, 1, size=(6, C)).astype(np.float32)).to(dev, dtype),
        _on(dev, dtype, rng, C, 5 * D, scale=0.1), _on(dev, dtype, rng, 5, D, C, scale=0.1),
    )
    got = _counted("tmix_prologue", lambda: tmix_prologue(*args))
    want = tmix_prologue_plain(*(a.float() for a in args))
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (B, T, C)
        _close(g, w, REL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("T,with_state", [(1, True), (37, True), (37, False)])
def test_wkv6_fused_kernel(dev, dtype, N, T, with_state):
    rng = np.random.default_rng(N + T)
    B, H, eps = 3, 4, 6.4e-4
    r, k, v, g = (_on(dev, dtype, rng, B, T, H, N) for _ in range(4))
    w = torch.from_numpy(rng.uniform(-8, 2.5, size=(B, T, H, N)).astype(np.float32)).to(dev)
    u = _on(dev, dtype, rng, H, N, scale=0.5)
    sc, bi = _on(dev, dtype, rng, H * N, scale=0.1, loc=1.0), _on(dev, dtype, rng, H * N, scale=0.1)
    s0 = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1) if with_state else None
    args = (r, k, v, w, u, g, sc, bi, s0)
    out, sT = _counted("wkv6_fused_output", lambda: wkv6_fused_output(*args, eps=eps))
    want_out, want_s = wkv6_fused_output_plain(
        *(a.float() if a is not None else None for a in args), eps=eps
    )
    assert out.dtype == dtype and out.shape == (B, T, H * N)
    assert sT.dtype == torch.float32 and sT.shape == (B, H, N, N)
    _close(out, want_out, REL[dtype])
    _close(sT, want_s, 1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(37, 2050), (1, 2048), (2, 3, 7168), (5, 40000), (3, 7)])
def test_quantize_rows_kernel_is_bit_equal(dev, dtype, shape):
    """Ragged rows and C (the vector and the generic paths), zero rows, and
    a row whose x / s land exactly on k + 0.5 (absmax 127 gives
    s = 127 * fl(1/127) = 1.0 exactly, so the halves are exact ties)."""
    rng = np.random.default_rng(len(shape))
    x = _on(dev, dtype, rng, *shape, scale=3.0)
    flat = x.view(-1, shape[-1])
    flat[0] = 0
    if flat.shape[0] > 1 and shape[-1] >= 8:
        flat[1] = 0
        flat[1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])
    q, s = _counted("quantize_rows", lambda: quantize_rows(x))
    want_q, want_s = quantize_rows_plain(x)
    assert q.dtype == torch.int8 and s.shape == shape[:-1] + (1,)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert q.view(-1, shape[-1])[0].abs().sum() == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("B", [1, 3, 64])
def test_wkv6_decode_kernel(dev, dtype, N, B):
    """Against the plain version, in place (out_state is state), and
    against K1 at T=1 on the same inputs."""
    rng = np.random.default_rng(B * N)
    H, eps = 4, 6.4e-4
    C = H * N
    r, k, v, g = (_on(dev, dtype, rng, B, C) for _ in range(4))
    w = torch.from_numpy(rng.uniform(-8, 2.5, size=(B, C)).astype(np.float32)).to(dev)
    u = _on(dev, dtype, rng, H, N, scale=0.5)
    sc, bi = _on(dev, dtype, rng, C, scale=0.1, loc=1.0), _on(dev, dtype, rng, C, scale=0.1)
    state = _on(dev, torch.float32, rng, B, H, N, N, scale=0.3)
    args = (r, k, v, w, g, u, sc, bi)
    want_out, want_s = wkv6_decode_step_plain(*(a.float() for a in args), state, eps=eps)
    inplace = state.clone()
    out, s = _counted("wkv6_decode_step",
                      lambda: wkv6_decode_step(*args, inplace, eps=eps, out_state=inplace))
    assert s.data_ptr() == inplace.data_ptr()
    assert out.dtype == dtype and out.shape == (B, C)
    _close(out, want_out, REL[dtype])
    _close(s, want_s, 1e-5)
    heads = (B, 1, H, N)
    k1_out, k1_s = wkv6_fused_output(*(t.view(heads) for t in (r, k, v, w)), u, g.view(heads),
                                     sc, bi, state, eps=eps)
    _close(out, k1_out.view(B, C), REL[dtype])
    _close(s, k1_s, 1e-5)


@pytest.mark.parametrize("M", [1, 16, 17, 64])
def test_int8_product_pads_small_row_counts(dev, M):
    """torch._int_mm takes more than 16 rows only; the product pads."""
    gen = torch.Generator(device=dev).manual_seed(M)
    xq = torch.randint(-127, 128, (M, 2048), generator=gen, device=dev, dtype=torch.int8)
    q = torch.randint(-127, 128, (512, 2048), generator=gen, device=dev, dtype=torch.int8)
    y = int8_product(xq, q)
    assert y.dtype == torch.int32 and y.shape == (M, 512)
    assert torch.equal(y.cpu(), xq.cpu().int() @ q.cpu().int().t())


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    before = launch_counts()
    x = torch.zeros(2, 8, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm(x.transpose(0, 1), torch.ones(64, device=dev), torch.zeros(64, device=dev))
    with pytest.raises(ValueError, match="D % 8"):
        tmix_prologue(x, torch.zeros(2, 64, device=dev), torch.ones(64, device=dev),
                      torch.zeros(64, device=dev), torch.zeros(6, 64, device=dev),
                      torch.zeros(64, 5 * 12, device=dev), torch.zeros(5, 12, 64, device=dev))
    r = torch.zeros(1, 4, 2, 48, device=dev)
    with pytest.raises(ValueError, match="head size"):
        wkv6_fused_output(r, r, r, r, torch.zeros(2, 48, device=dev), r,
                          torch.ones(96, device=dev), torch.zeros(96, device=dev), eps=1e-3)
    r = torch.zeros(1, 96, device=dev)
    with pytest.raises(ValueError, match="head size"):
        wkv6_decode_step(r, r, r, r, r, torch.zeros(2, 48, device=dev), torch.ones(96, device=dev),
                         torch.zeros(96, device=dev), torch.zeros(1, 2, 48, 48, device=dev), eps=1e-3)
    with pytest.raises(TypeError, match="dtype"):
        quantize_rows(torch.zeros(4, 64, device=dev, dtype=torch.float16))
    assert launch_counts() == before


def test_model_kernel_route_matches_plain_route(dev):
    """A 2-layer fp32 model: the kernel route against the plain route on the
    card, hidden states and final state, with the launches of one forward."""
    cfg = ModelConfig(n_layer=2, n_embd=256, vocab_size=1000, head_size=64, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    sd = init_rwkv_params(cfg, generator=gen, device=dev)
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen, device=dev) * 0.5 / sd[key].shape[1] ** 0.5
    model = load_state_dict_into(RWKV(cfg, device=dev), sd)
    tokens = torch.randint(4, 1000, (3, 45), generator=gen, device=dev)
    before = launch_counts()
    with torch.inference_mode():
        got, got_state = model(tokens, return_hidden=True, return_logits=False)
        after = launch_counts()
        want, want_state = model(tokens, return_hidden=True, return_logits=False, reference=True)
    assert {k: after[k] - before[k] for k in after} == dict(
        NO_LAUNCH, layer_norm=4, tmix_prologue=2, wkv6_fused_output=2)
    assert launch_counts() == after        # the plain route launches nothing
    _close(got, want, 1e-4)
    for key in want_state:
        _close(got_state[key], want_state[key], 1e-4)


@pytest.mark.parametrize("quant", [None, "int8c"])
def test_model_decode_kernel_route_matches_plain_route(dev, quant):
    """A 2-layer fp32 model, decode steps from a prefilled state: the
    kernel route against the plain route on the card, logits and state,
    with the launches of one step (8 quantize_rows a layer under int8c)."""
    cfg = ModelConfig(n_layer=2, n_embd=256, vocab_size=1000, head_size=64, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(1)
    sd = init_rwkv_params(cfg, generator=gen, device=dev)
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen, device=dev) * 0.5 / sd[key].shape[1] ** 0.5
    model = load_state_dict_into(RWKV(cfg, device=dev), sd)
    if quant:
        quantize_model(model, quant)
    tokens = torch.randint(4, 1000, (3, 20), generator=gen, device=dev)
    with torch.inference_mode():
        _, state = model(tokens[:, :12])
        plain_state = {k: v.clone() for k, v in state.items()}
        for t in range(12, 20):
            before = launch_counts()
            got, state = rwkv_decode_step(model, tokens[:, t], state, out=state)
            after = launch_counts()
            want, plain_state = rwkv_decode_step(model, tokens[:, t], plain_state, reference=True)
            assert launch_counts() == after
            assert {k: after[k] - before[k] for k in after} == dict(
                NO_LAUNCH, layer_norm=4, tmix_prologue=2, wkv6_decode_step=2,
                quantize_rows=16 if quant else 0)
            _close(got, want, 1e-4)
    for key in state:
        _close(state[key], plain_state[key], 1e-4)


BWD_REL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}
WKV_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [256, 2048])
@pytest.mark.parametrize("T", [1, 37, 64, 65])
def test_tmix_prologue_bwd_kernel(dev, dtype, C, T):
    """B.5 against autograd through the plain version (fp32, same inputs and
    cotangents), every gradient; dxln missing as in the model; bit-equal
    twice."""
    rng = np.random.default_rng(T * C)
    B, D = 2, 32
    args = (
        _on(dev, dtype, rng, B, T, C), _on(dev, dtype, rng, B, C),
        _on(dev, dtype, rng, C, scale=0.2, loc=1.0), _on(dev, dtype, rng, C, scale=0.2),
        torch.from_numpy(rng.uniform(0, 1, size=(6, C)).astype(np.float32)).to(dev, dtype),
        _on(dev, dtype, rng, C, 5 * D, scale=0.1), _on(dev, dtype, rng, 5, D, C, scale=0.1),
    )
    cts = [_on(dev, dtype, rng, B, T, C) for _ in range(5)] + [None]
    got = _counted("tmix_prologue_bwd", lambda: tmix_prologue_bwd(*args, cts))
    again = tmix_prologue_bwd(*args, cts)
    want = tmix_prologue_bwd_plain(*(a.float() for a in args),
                                   [c.float() if c is not None else None for c in cts])
    assert got[0].dtype == dtype
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and torch.equal(g, a)
        _close(g, w, BWD_REL[dtype])
    dx_only = tmix_prologue_bwd(*args, cts, weights=False)
    assert torch.equal(dx_only[0], got[0]) and torch.equal(dx_only[1], got[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("T", [1, 37, 512])
@pytest.mark.parametrize("with_state", [True, False])
def test_wkv6_fused_bwd_kernel(dev, dtype, N, T, with_state):
    """B.6 + B.7 against autograd through the plain version, decays from ~1
    to e^-20 (w up to +3), with and without s0 and dsT; bit-equal twice."""
    rng = np.random.default_rng(N + T)
    B, H, eps = 2, 4, 6.4e-4
    r, k, v, g = (_on(dev, dtype, rng, B, T, H, N) for _ in range(4))
    w = torch.from_numpy(rng.uniform(-8, 3, size=(B, T, H, N)).astype(np.float32)).to(dev)
    u = _on(dev, dtype, rng, H, N, scale=0.5)
    sc, bi = _on(dev, dtype, rng, H * N, scale=0.1, loc=1.0), _on(dev, dtype, rng, H * N, scale=0.1)
    s0 = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1) if with_state else None
    dout = _on(dev, dtype, rng, B, T, H * N)
    dsT = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1) if with_state else None
    args = (r, k, v, w, u, g, sc, bi, s0, dout, dsT)
    before = launch_counts()
    got = wkv6_fused_output_bwd(*args, eps=eps)
    after = launch_counts()
    assert after["wkv6_bwd_forward_pass"] == before["wkv6_bwd_forward_pass"] + 1
    assert after["wkv6_bwd_reverse_pass"] == before["wkv6_bwd_reverse_pass"] + 1
    again = wkv6_fused_output_bwd(*args, eps=eps)
    want = wkv6_fused_output_bwd_plain(
        *(a.float() if a is not None else None for a in args), eps=eps)
    names = ["dr", "dk", "dv", "dw", "du", "ds0", "dg", "dln_scale", "dln_bias"]
    # At T=1 from a zero state the output is the u-bonus alone, y = (r.(u k)) v,
    # so the GroupNorm adjoint leaves v.dy = 0: dr, dk and du are zero in
    # exact arithmetic and both sides give rounding noise. They are held
    # against the scale of dv, the gradient that the same dy carries.
    zero = ("dr", "dk", "du") if T == 1 and not with_state else ()
    dv_max = want[2].abs().max().item()
    for name, gr, a, wa in zip(names, got, again, want):
        if wa is None:
            assert gr is None, name
            continue
        assert gr.shape == wa.shape and torch.equal(gr, a), name
        _close(gr, wa, WKV_BWD_REL[dtype], name, dv_max if name in zero else None)


def _model(dev, seed, n_embd=256):
    cfg = ModelConfig(n_layer=2, n_embd=n_embd, vocab_size=1000, head_size=64, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = init_rwkv_params(cfg, generator=gen, device=dev)
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen, device=dev) * 0.5 / sd[key].shape[1] ** 0.5
    return load_state_dict_into(RWKV(cfg, device=dev), sd), gen


def _grads(model, tokens, labels, *, reference, remat=False):
    model.zero_grad()
    logits, _ = model(tokens, reference=reference, remat=remat, t1_step=False)
    causal_lm_loss(logits, labels).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.requires_grad}


def test_model_backward_reaches_every_parameter(dev):
    """Every parameter trains: the kernel route's gradients (through K1-K3
    and B.5-B.7) against the plain route's, each one present and within
    1e-3 * max|plain|."""
    model, gen = _model(dev, 2)
    tokens = torch.randint(4, 1000, (2, 45), generator=gen, device=dev)
    labels = torch.randint(4, 1000, (2, 45), generator=gen, device=dev)
    before = launch_counts()
    got = _grads(model, tokens, labels, reference=False)
    after = launch_counts()
    want = _grads(model, tokens, labels, reference=True)
    assert launch_counts() == after
    assert {k: after[k] - before[k] for k in after} == dict(
        NO_LAUNCH, layer_norm=4, tmix_prologue=2, wkv6_fused_output=2, tmix_prologue_bwd=2,
        wkv6_bwd_forward_pass=2, wkv6_bwd_reverse_pass=2)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] is not None and bool(got[name].abs().max() > 0), name
        _close(got[name], want[name], 1e-3)


@pytest.mark.parametrize("remat", [False, True])
def test_lora_train_step_kernel_route_matches_plain_route(dev, remat):
    """2-layer LoRA (B seeded non-zero): A/B gradients of the kernel route
    against the plain route, and the launches of one step. Layer 0's K2
    inputs need no gradient (frozen embedding and ln0), so B.5 runs for
    layer 1 only; remat runs each block's forward kernels twice."""
    model, gen = _model(dev, 3)
    lc = LoraConfig(r=8, alpha=32.0)
    adapter = init_lora_params(model, lc, gen)
    for ab in adapter.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=gen, device=dev) * 0.05
    apply_lora(model, lc, adapter)
    tokens = torch.randint(4, 1000, (2, 45), generator=gen, device=dev)
    labels = torch.randint(4, 1000, (2, 45), generator=gen, device=dev)
    before = launch_counts()
    got = _grads(model, tokens, labels, reference=False, remat=remat)
    after = launch_counts()
    want = _grads(model, tokens, labels, reference=True)
    fwd = 2 if remat else 1
    assert {k: after[k] - before[k] for k in after} == dict(
        NO_LAUNCH, layer_norm=3 * fwd + 1, tmix_prologue=2 * fwd, wkv6_fused_output=2 * fwd,
        tmix_prologue_bwd=1, wkv6_bwd_forward_pass=2, wkv6_bwd_reverse_pass=2)
    assert len(got) == 2 * 8 * 2
    for name in want:
        assert bool(got[name].abs().max() > 0), name
        _close(got[name], want[name], 1e-3)


def test_state_params_grads_kernel_route_match_plain_route(dev):
    model, gen = _model(dev, 4)
    model.requires_grad_(False)
    model.add_state_params()
    with torch.no_grad():
        for blk in model.blocks:
            blk.att.time_state.normal_(0, 0.1, generator=gen)
    tokens = torch.randint(4, 1000, (3, 40), generator=gen, device=dev)
    labels = torch.randint(4, 1000, (3, 40), generator=gen, device=dev)
    grads = []
    for reference in (False, True):
        model.zero_grad()
        logits, _ = model(tokens, reference=reference, use_state_params=True, t1_step=False)
        causal_lm_loss(logits, labels).backward()
        grads.append([blk.att.time_state.grad.clone() for blk in model.blocks])
    for g, w in zip(*grads):
        _close(g, w, 1e-3)


def test_wrappers_without_a_backward_raise_under_grad(dev):
    """B.4 and B.9 refuse inputs that require grad instead of returning
    outputs detached from the graph; under no_grad they run."""
    x = torch.randn(4, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        quantize_rows(x)
    with torch.no_grad():
        quantize_rows(x)
    r = torch.randn(1, 64, device=dev, requires_grad=True)
    args = (r, r, r, r, r, torch.ones(2, 32, device=dev), torch.ones(64, device=dev),
            torch.zeros(64, device=dev), torch.zeros(1, 2, 32, 32, device=dev))
    with pytest.raises(RuntimeError, match="no backward"):
        wkv6_decode_step(*args, eps=1e-3)
    with torch.inference_mode():
        wkv6_decode_step(*args, eps=1e-3)
