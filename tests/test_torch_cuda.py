"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the edge shapes the main path does not reach: ragged T and C, T=1, both
head sizes, fp32 as well as bf16, and no initial state. The plain version runs
in fp32 on the same (dtype-rounded) inputs, except the int8 row quantizer,
which is held bit-equal to its plain version on the same input.

These tests need an NVIDIA GPU and skip elsewhere. The GPU machine has no
JAX, so run them there without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

The fused decode kernels B.10-B.12 are held to their plain versions at 2e-5
(prologues) and 3e-5 (the whole block) of max|plain| in fp32 and one bf16
rounding in bf16, B.13 as B.9 with its state bit-equal to B.9's; each is
called twice and held bit-equal, and its gradients (a recompute through the
plain version) equal autograd through the plain version. The redesigned
bf16 bodies of B.10 (clusters over C slices) and B.12 (tensor-map weight
streams) are also held to the plain mirrors of their factorings at the same
limits, and B.10's two bodies to each other within two bf16 roundings.

K2 and K1 each have two bodies (tensor cores or chunked for bf16, CUDA
cores or sequential for fp32); both are held to the same limits, at shapes
whose 64-row tiles cross batch rows and whose 16-step chunks end ragged, and
at strong, wide and no decay.

Tolerances: out <= REL[dtype] * max|plain| (fp32: summation order only;
bf16: one rounding of each output), the WKV state <= 1e-4 * max|plain|
(fp32 in both). Backward kernels, each gradient against autograd through
the plain version: B.5 <= 5e-4 (fp32) / 2e-2 (bf16) * max|plain|, B.6 + B.7
<= 1e-4 / 2e-2; model gradients (kernel route vs plain route, fp32) <=
1e-3 * max|plain|. Two calls of a backward kernel are bit-equal. The
unfused WKV B.8: y and the final state <= 2e-5 * max|plain| for its
sequential body (fp32 sums on both sides of the same values) and <= 1e-4 for
its chunked body (the state and r exp(c) enter the tensor cores as two bf16
limbs), its two-pass backward as B.6 + B.7.

B.5 and B.8 have two bodies each since their redesign (tensor cores or
chunked for bf16, CUDA cores or sequential for fp32 and the shapes the new
ones do not take): both are held to their plain versions and to each other
on row tiles that straddle sequences (B.5) and on chunks, decays and walks
(B.8), and the new ones to their plain-PyTorch mirrors.
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
from rwkv_lm_ext_tpu_torch.ops import _lib, launch_counts
from rwkv_lm_ext_tpu_torch.ops.decode_fused import (
    _launch_att_prep,
    att_prep_fused,
    att_prep_plain,
    att_prep_sliced_plain,
    b10_body,
    ffn_block_fused,
    ffn_block_plain,
    ffn_block_split_plain,
    ffn_prep_fused,
    ffn_prep_plain,
    ffn_prep_warp_order_plain,
    ffn_value_splits,
)
from rwkv_lm_ext_tpu_torch.ops.ddlerp import (
    B5_BODIES,
    _launch_k2,
    b5_body,
    k2_body,
    tmix_prologue,
    tmix_prologue_bwd,
    tmix_prologue_bwd_plain,
    tmix_prologue_bwd_tiled_plain,
    tmix_prologue_plain,
)
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows, quantize_rows_plain
from rwkv_lm_ext_tpu_torch.ops.wkv import (
    WKV_BODIES,
    wkv,
    wkv6_bi,
    wkv6_bi_plain,
    wkv_body,
    wkv_bwd,
    wkv_bwd_chunked_plain,
    wkv_bwd_plain,
    wkv_chunked_plain,
    wkv_plain,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import (
    b13_grid,
    transpose_state,
    wkv6_decode_step,
    wkv6_decode_step_plain,
    wkv6_decode_step_transposed,
)
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import (
    k1_body,
    wkv6_fused_output,
    wkv6_fused_output_bwd,
    wkv6_fused_output_bwd_chunked_plain,
    wkv6_fused_output_bwd_plain,
    wkv6_fused_output_chunked_plain,
    wkv6_fused_output_plain,
    wkv_bwd_body,
)
from rwkv_lm_ext_tpu_torch.train.loop import mlm_loss_fn
from rwkv_lm_ext_tpu_torch.train.losses import causal_lm_loss

pytestmark = pytest.mark.cuda

REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]
NO_LAUNCH = {"layer_norm": 0, "tmix_prologue": 0, "wkv6_fused_output": 0, "wkv6_decode_step": 0,
             "quantize_rows": 0, "tmix_prologue_bwd": 0, "wkv6_bwd_forward_pass": 0,
             "wkv6_bwd_reverse_pass": 0, "wkv": 0, "wkv_bwd_state_pass": 0,
             "att_prep_fused": 0, "ffn_prep_fused": 0, "ffn_block_fused": 0,
             "wkv6_decode_step_transposed": 0}


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
@pytest.mark.parametrize("C", [256, 2048, 2050, 4096])
@pytest.mark.parametrize("B,T", [(64, 1), (3, 37), (2, 130), (5, 13)])
def test_tmix_prologue_kernel_row_tiles(dev, dtype, B, T, C):
    """K2's tensor-core body tiles the flattened rows b*T + t by 64: tiles
    that cross batch rows (each row's predecessor is then its own batch row's
    shift or the row before), end ragged, or hold a single step of 64
    sequences; C that is no multiple of the 64-column slab, and C = 2050,
    which the CUDA-core body takes. Both bodies, where the shape allows both,
    against the plain version at the same limit."""
    rng = np.random.default_rng(B * T + C)
    D = 64 if C == 4096 else 32
    args = (
        _on(dev, dtype, rng, B, T, C), _on(dev, dtype, rng, B, C),
        _on(dev, dtype, rng, C, scale=0.2, loc=1.0), _on(dev, dtype, rng, C, scale=0.2),
        torch.from_numpy(rng.uniform(0, 1, size=(6, C)).astype(np.float32)).to(dev, dtype),
        _on(dev, dtype, rng, C, 5 * D, scale=0.1), _on(dev, dtype, rng, 5, D, C, scale=0.1),
    )
    want = tmix_prologue_plain(*(a.float() for a in args))
    tensor_cores = dtype == torch.bfloat16 and C % 8 == 0
    assert k2_body(dtype, C, D) == ("tensor_cores" if tensor_cores else "cuda_cores")
    got = _counted("tmix_prologue", lambda: tmix_prologue(*args))
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (B, T, C)
        _close(g, w, REL[dtype])
    if tensor_cores:
        other = _launch_k2(args[0], *args[1:], 1e-5, body="cuda_cores")
        for g, w in zip(other, want):
            _close(g, w, REL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("decay", [(-8.0, 2.5), (2.5, 3.2), (-8.0, -8.0)])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 37, 512])
def test_wkv6_fused_kernel_chunks_and_decays(dev, dtype, N, decay, T):
    """K1 over whole, ragged and single-step chunks of 16, at a wide decay
    range, at strong decay (w in [2.5, 3.2]: per-step decay down to 2e-11,
    where a factoring by exp(+c) overflows) and without decay (w = -8: the
    state only grows): gated output and final state against the plain
    recurrence in fp32, two calls bit-equal. bf16 runs the chunked body, fp32
    the sequential one."""
    rng = np.random.default_rng(N + T)
    B, H, eps = 2, 3, 6.4e-4
    assert k1_body(dtype) == ("chunked" if dtype == torch.bfloat16 else "sequential")
    r, k, v, g = (_on(dev, dtype, rng, B, T, H, N) for _ in range(4))
    w = torch.from_numpy(rng.uniform(*decay, size=(B, T, H, N)).astype(np.float32)).to(dev)
    u = _on(dev, dtype, rng, H, N, scale=0.5)
    sc, bi = _on(dev, dtype, rng, H * N, scale=0.1, loc=1.0), _on(dev, dtype, rng, H * N, scale=0.1)
    s0 = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1)
    args = (r, k, v, w, u, g, sc, bi, s0)
    out, sT = _counted("wkv6_fused_output", lambda: wkv6_fused_output(*args, eps=eps))
    again, sT_again = wkv6_fused_output(*args, eps=eps)
    assert torch.equal(out, again) and torch.equal(sT, sT_again)
    want_out, want_s = wkv6_fused_output_plain(*(a.float() for a in args), eps=eps)
    _close(out, want_out, REL[dtype])
    _close(sT, want_s, 1e-4)
    # the kernel's factoring in plain PyTorch, chunk for chunk
    mirror_out, mirror_s = wkv6_fused_output_chunked_plain(*(a.float() for a in args), eps=eps)
    _close(out, mirror_out, REL[dtype])
    _close(sT, mirror_s, 1e-4)


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
# the fp32 gradients (dw, du, ds0, dln_scale, dln_bias) on bf16 inputs: no
# rounding to bf16, only the kernel's own sums
WKV_BWD_REL_FP32_OUT = 1e-3


def _bwd_rel(dtype, grad):
    return WKV_BWD_REL_FP32_OUT if dtype == torch.bfloat16 and grad.dtype == torch.float32 \
        else WKV_BWD_REL[dtype]


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


BWD_FORMS = ["fused", "unfused"]


@pytest.mark.parametrize("form", BWD_FORMS)
@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("decay", [(-8.0, 3.0), (2.5, 3.2), (-8.0, -8.0)])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 37, 512])
def test_wkv_bwd_bodies_chunks_and_decays(dev, form, N, decay, T):
    """The two bodies of the WKV backward on the same bf16 inputs, each
    against autograd through the plain version within 2e-2 of max|plain|
    (1e-3 for the fp32 gradients dw, du, ds0, dln_scale and dln_bias):
    the chunked one (chunks of 16 on the tensor cores, the default for bf16)
    and the sequential fp64 one, over whole, ragged and single-step chunks,
    at wide, strong (w in [2.5, 3.2], where the sequential identity for dw
    cancels) and no decay. The fused form (B.6 + B.7) with s0 and dsT; the
    unfused form (B.8's backward) forwards and in reverse over all T and over
    ragged prefixes. Two calls of each body bit-equal; for T <= 37 the
    chunked body also against its factoring in plain PyTorch (fp64)."""
    rng = np.random.default_rng(N + T + int(decay[0]))
    B, H, eps, dtype = 3, 2, 6.4e-4, torch.bfloat16
    assert wkv_bwd_body(dtype, N) == "chunked" and wkv_bwd_body(torch.float32, N) == "sequential"
    r, k, v, g = (_on(dev, dtype, rng, B, T, H, N) for _ in range(4))
    w = torch.from_numpy(rng.uniform(*decay, size=(B, T, H, N)).astype(np.float32)).to(dev)
    u = _on(dev, dtype, rng, H, N, scale=0.5)
    s0 = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1)
    dsT = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1)
    if form == "fused":
        sc, bi = _on(dev, dtype, rng, H * N, scale=0.1, loc=1.0), _on(dev, dtype, rng, H * N, scale=0.1)
        args = (r, k, v, w, u, g, sc, bi, s0, _on(dev, dtype, rng, B, T, H * N), dsT)
        names = ["dr", "dk", "dv", "dw", "du", "ds0", "dg", "dln_scale", "dln_bias"]
        calls = [(lambda body: wkv6_fused_output_bwd(*args, eps=eps, body=body),
                  lambda: wkv6_fused_output_bwd_plain(*_f32(*args), eps=eps),
                  lambda: wkv6_fused_output_bwd_chunked_plain(*(x.cpu() for x in _f32(*args)),
                                                              eps=eps))]
    else:
        dy = _on(dev, torch.float32, rng, B, T, H, N)
        lengths = torch.tensor([0, min(1, T), max(T - 2, 1)], dtype=torch.int32, device=dev)
        names = ["dr", "dk", "dv", "dw", "du", "ds0"]
        calls = []
        for uu, ss, reverse, ln in ((u, s0, False, None), (None, s0, True, lengths),
                                    (u, None, False, lengths)):
            a = (r, k, v, w, uu, ss, dy, dsT)
            kw = dict(reverse=reverse, lengths=ln)
            calls.append((
                lambda body, a=a, kw=kw: wkv_bwd(*a, body=body, **kw),
                lambda a=a, kw=kw: wkv_bwd_plain(*_f32(*a), **kw),
                lambda a=a, kw=kw: wkv_bwd_chunked_plain(
                    *(None if x is None else x.float().cpu() for x in a),
                    **{n: (x.cpu() if torch.is_tensor(x) else x) for n, x in kw.items()})))
    for kernel, plain, mirror in calls:
        want = plain()
        # at T=1 from a zero state a gradient may be zero analytically: those
        # are held against the largest of dr, dk, dv of the same call
        top = max(w_.abs().max().item() for w_ in want[:3])
        for body in ("chunked", "sequential"):
            got, again = kernel(body), kernel(body)
            for name, gr, a_, wa in zip(names, got, again, want):
                assert (gr is None) == (wa is None), name
                if wa is None:
                    continue
                assert torch.equal(gr, a_), (body, name)
                _close(gr, wa, _bwd_rel(dtype, gr), (body, name), max(wa.abs().max().item(), top))
            if body == "chunked" and T <= 37:
                for name, gr, m in zip(names, got, mirror()):
                    if m is not None:
                        _close(gr, m.to(dev), _bwd_rel(dtype, gr), ("mirror", name),
                               max(m.abs().max().item(), top))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["K1", "B.6+B.7", "B.8", "B.9"])
def test_head_size_16_sequential_kernels(dev, dtype, kernel):
    """N = 16 (a block of 16 threads, one partial warp) through the
    sequential bodies that take it: K1, B.6 + B.7, B.8 and its backward
    (reverse over ragged prefixes), the decode step B.9, each against its
    plain version at the limits of the wider heads."""
    rng = np.random.default_rng(16)
    N, H, B, T, eps = 16, 4, 3, 37, 6.4e-4
    assert k1_body(dtype, N) == "sequential" == wkv_bwd_body(dtype, N)
    r, k, v, g = (_on(dev, dtype, rng, B, T, H, N) for _ in range(4))
    w = torch.from_numpy(rng.uniform(-8, 3, size=(B, T, H, N)).astype(np.float32)).to(dev)
    u = _on(dev, dtype, rng, H, N, scale=0.5)
    sc, bi = _on(dev, dtype, rng, H * N, scale=0.1, loc=1.0), _on(dev, dtype, rng, H * N, scale=0.1)
    s0 = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1)
    dsT = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1)
    if kernel == "K1":
        args = (r, k, v, w, u, g, sc, bi, s0)
        out, sT = _counted("wkv6_fused_output", lambda: wkv6_fused_output(*args, eps=eps))
        want_out, want_s = wkv6_fused_output_plain(*_f32(*args), eps=eps)
        _close(out, want_out, REL[dtype])
        _close(sT, want_s, 1e-4)
    elif kernel == "B.6+B.7":
        args = (r, k, v, w, u, g, sc, bi, s0, _on(dev, dtype, rng, B, T, H * N), dsT)
        got = wkv6_fused_output_bwd(*args, eps=eps)
        want = wkv6_fused_output_bwd_plain(*_f32(*args), eps=eps)
        assert all(torch.equal(a, b) for a, b in zip(got, wkv6_fused_output_bwd(*args, eps=eps)))
        for gr, wa in zip(got, want):
            _close(gr, wa, WKV_BWD_REL[dtype])
    elif kernel == "B.8":
        lengths = torch.tensor([0, 1, 30], dtype=torch.int32, device=dev)
        kw = dict(reverse=True, lengths=lengths)
        y, sT = _counted("wkv", lambda: wkv(r, k, v, w, u, s0, **kw))
        py, psT = wkv_plain(*_f32(r, k, v, w, u, s0), **kw)
        _close(y, py, WKV_REL)
        _close(sT, psT, WKV_REL)
        a = (r, k, v, w, u, s0, _on(dev, torch.float32, rng, B, T, H, N), dsT)
        for gr, wa in zip(wkv_bwd(*a, **kw), wkv_bwd_plain(*_f32(*a), **kw)):
            _close(gr, wa, WKV_BWD_REL[dtype])
    else:
        C = H * N
        args = tuple(x[:, 0].reshape(B, C) for x in (r, k, v)) + (w[:, 0].reshape(B, C).contiguous(),
                                                                  g[:, 0].reshape(B, C), u, sc, bi)
        args = tuple(x.contiguous() for x in args)
        want_out, want_s = wkv6_decode_step_plain(*_f32(*args), s0, eps=eps)
        out, st = _counted("wkv6_decode_step", lambda: wkv6_decode_step(*args, s0, eps=eps))
        _close(out, want_out, REL[dtype])
        _close(st, want_s, 1e-5)


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
    """B.4 refuses inputs that require grad instead of returning outputs
    detached from the graph; under no_grad it runs. B.9 differentiates by
    recomputing from its saved inputs, so only its in-place form refuses."""
    x = torch.randn(4, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        quantize_rows(x)
    with torch.no_grad():
        quantize_rows(x)
    r = torch.randn(1, 64, device=dev, requires_grad=True)
    state = torch.zeros(1, 2, 32, 32, device=dev)
    args = (r, r, r, r, r, torch.ones(2, 32, device=dev), torch.ones(64, device=dev),
            torch.zeros(64, device=dev), state)
    with pytest.raises(RuntimeError, match="in-place"):
        wkv6_decode_step(*args, eps=1e-3, out_state=state)
    out, _ = wkv6_decode_step(*args, eps=1e-3)
    assert out.grad_fn is not None
    with torch.inference_mode():
        wkv6_decode_step(*args, eps=1e-3, out_state=state)


WKV_REL = 2e-5
WKV_CHUNKED_REL = 1e-4


def wkv_rel(dtype, N):
    """B.8's limit for y and the final state, x max|plain|, by the body that
    a call of this dtype and head size runs."""
    return WKV_CHUNKED_REL if wkv_body(dtype, N) == "chunked" else WKV_REL


def _wkv_case(dev, dtype, rng, B, T, H, N, w_hi=3.0):
    r, k, v = (_on(dev, dtype, rng, B, T, H, N) for _ in range(3))
    w = torch.from_numpy(rng.uniform(-8, w_hi, size=(B, T, H, N)).astype(np.float32)).to(dev)
    lengths = torch.from_numpy(rng.integers(0, T + 1, size=B).astype(np.int32)).to(dev)
    lengths[0], lengths[-1] = 0, min(1, T)
    return dict(r=r, k=k, v=v, w=w, u=_on(dev, dtype, rng, H, N, scale=0.5),
                s0=_on(dev, torch.float32, rng, B, H, N, N, scale=0.1),
                dy=_on(dev, torch.float32, rng, B, T, H, N),
                dsT=_on(dev, torch.float32, rng, B, H, N, N, scale=0.1), lengths=lengths)


def _f32(*tensors):
    return [None if t is None else t.float() for t in tensors]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("T", [1, 37, 512])
@pytest.mark.parametrize("variant", ["causal", "bare", "reverse", "reverse_ragged", "ragged"])
def test_wkv_kernel_and_its_backward(dev, dtype, N, T, variant):
    """B.8 and its two-pass backward against wkv_plain and autograd through
    it: with and without u, s0 and dsT, forwards and in reverse, over all T
    and over ragged prefixes (lengths 0 and 1 among them), decays from ~1
    down to e^-20 (w up to +3)."""
    rng = np.random.default_rng(T + N)
    c = _wkv_case(dev, dtype, rng, 3, T, 4 if N == 32 else 2, N)
    u, s0, dsT, reverse, lengths = {
        "causal": (c["u"], c["s0"], c["dsT"], False, None),
        "bare": (None, None, None, False, None),
        "reverse": (c["u"], None, c["dsT"], True, None),
        "reverse_ragged": (None, c["s0"], None, True, c["lengths"]),
        "ragged": (c["u"], c["s0"], c["dsT"], False, c["lengths"]),
    }[variant]
    kw = dict(reverse=reverse, lengths=lengths)
    y, sT = _counted("wkv", lambda: wkv(c["r"], c["k"], c["v"], c["w"], u, s0, **kw))
    py, psT = wkv_plain(*_f32(c["r"], c["k"], c["v"], c["w"], u, s0), **kw)
    assert y.dtype == sT.dtype == torch.float32
    _close(y, py, wkv_rel(dtype, N), "y")
    _close(sT, psT, wkv_rel(dtype, N), "sT")
    if lengths is not None:
        beyond = torch.arange(T, device=dev)[None, :] >= lengths[:, None]
        assert not beyond.any() or float(y[beyond].abs().max()) == 0.0

    args = (c["r"], c["k"], c["v"], c["w"], u, s0, c["dy"], dsT)
    before = launch_counts()
    got = wkv_bwd(*args, **kw)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        NO_LAUNCH, wkv_bwd_state_pass=1, wkv6_bwd_reverse_pass=1)
    again = wkv_bwd(*args, **kw)
    want = wkv_bwd_plain(*_f32(*args), **kw)
    # at T=1 a gradient may be zero analytically (dw from a zero state; dr,
    # dk, du without a state or a dsT that reaches them): those are held
    # against the largest of dr, dk, dv of the same call
    top = max(w_.abs().max().item() for w_ in want[:3])
    for name, gr, a, wa in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, again, want):
        if wa is None:
            assert gr is None, name
            continue
        assert gr.shape == wa.shape and torch.equal(gr, a), name
        assert gr.dtype == (torch.float32 if name in ("dw", "du", "ds0") else dtype), name
        scale = max(wa.abs().max().item(), top) if T == 1 else None
        _close(gr, wa, WKV_BWD_REL[dtype], name, scale)
        if lengths is not None and gr.dim() == 4 and gr.shape[1] == T:
            assert not beyond.any() or float(gr[beyond].abs().max()) == 0.0, name


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lengths", ["none", "full", "ragged"])
def test_wkv6_bi_matches_the_flip_composition(dev, dtype, lengths):
    """Two launches against six gathers around the causal scan, forward and
    through autograd; a shared (H, N, N) initial state sums its gradient."""
    rng = np.random.default_rng(5)
    c = _wkv_case(dev, dtype, rng, 4, 37, 2, 64)
    L = {"none": None, "full": torch.full_like(c["lengths"], 37), "ragged": c["lengths"]}[lengths]
    names = ("r", "k", "v", "w", "u")
    kl = [c[n].clone().requires_grad_() for n in names]
    pl = [c[n].float().clone().requires_grad_() for n in names]
    before = launch_counts()["wkv"]
    y = wkv6_bi(*kl, L)
    assert launch_counts()["wkv"] == before + 2
    yp = wkv6_bi_plain(*pl, L)
    _close(y, yp, wkv_rel(dtype, 64), "y")
    y.backward(c["dy"])
    yp.backward(c["dy"])
    for n, a, b in zip(names, kl, pl):
        assert a.grad.dtype == a.dtype
        _close(a.grad, b.grad, WKV_BWD_REL[dtype], "d" + n)

    shared = c["s0"][0].clone().requires_grad_()
    ys, _ = wkv(c["r"], c["k"], c["v"], c["w"], c["u"], shared)
    ys.backward(c["dy"])
    ref = c["s0"][0].clone().requires_grad_()
    yr, _ = wkv_plain(*_f32(c["r"], c["k"], c["v"], c["w"], c["u"]), ref)
    yr.backward(c["dy"])
    _close(ys, yr, wkv_rel(dtype, 64), "shared state y")
    _close(shared.grad, ref.grad, WKV_BWD_REL[torch.float32], "shared ds0")


def test_wkv_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    def mk(*shape, dtype=torch.float32):
        return torch.zeros(*shape, device=dev, dtype=dtype)

    with pytest.raises(ValueError, match="head size 48"):
        wkv(mk(1, 4, 2, 48), mk(1, 4, 2, 48), mk(1, 4, 2, 48), mk(1, 4, 2, 48), mk(2, 48))
    r = mk(2, 4, 2, 32)
    with pytest.raises(TypeError):
        wkv(r, r.to(torch.bfloat16), r, r, None)
    with pytest.raises(ValueError):
        wkv(r, r, r, r, mk(2, 16))
    with pytest.raises(ValueError):
        wkv(r, r, r, r, None, mk(3, 2, 32, 32))
    with pytest.raises(ValueError, match="lengths"):
        wkv(r, r, r, r, None, lengths=torch.zeros(3, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="lengths"):
        wkv(r, r, r, r, None, lengths=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        wkv(r.half(), r.half(), r.half(), r, None)


def _mlm_model(dev, seed, dtype="float32"):
    cfg = ModelConfig(n_layer=2, n_embd=256, vocab_size=1000, head_size=64, dtype=dtype,
                      param_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = init_rwkv_params(cfg, generator=gen, device=dev)
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen, device=dev) * 0.5 / sd[key].shape[1] ** 0.5
    sd["emb.weight"] = torch.randn(sd["emb.weight"].shape, generator=gen, device=dev) * 0.3
    return load_state_dict_into(RWKV(cfg, device=dev), sd), gen


def _mlm_batch(dev, gen):
    tokens = torch.randint(4, 1000, (3, 45), generator=gen, device=dev)
    tokens[0, 30], tokens[0, 31:] = 1, 0
    tokens[1, -1] = 1
    tokens[2, 9], tokens[2, 10:] = 1, 0
    labels = torch.full_like(tokens, -100)
    masked = (torch.rand(3, 45, generator=gen, device=dev) < 0.3) & (tokens > 3)
    labels[masked] = tokens[masked]
    return {"input_ids": torch.where(masked, 3, tokens), "labels": labels}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("mode", ["average", "fused"])
def test_mlm_step_kernel_route_matches_plain_route(dev, mode, remat):
    """A 2-layer full-parameter mlm step over fp32 master weights: every
    gradient but the untied head's is present and within 1e-3 * max|plain|
    of the plain route's, and the launches of the step are exact: K3 for
    ln0, 2 x (ln1, ln2) and ln_out, B.8 twice a layer, each with its two
    backward passes; remat runs each block's forward kernels twice."""
    model, gen = _mlm_model(dev, 6)
    batch = _mlm_batch(dev, gen)
    grads = {}
    for reference in (False, True):
        model.zero_grad()
        before = launch_counts()
        mlm_loss_fn(model, batch, remat=remat, mode=mode, reference=reference).backward()
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        fwd = 2 if remat else 1
        assert delta == (NO_LAUNCH if reference else dict(
            NO_LAUNCH, layer_norm=5 * fwd + 1, wkv=4 * fwd, wkv_bwd_state_pass=4,
            wkv6_bwd_reverse_pass=4))
        grads[reference] = {n: None if p.grad is None else p.grad.clone()
                            for n, p in model.named_parameters()}
    for name, want in grads[True].items():
        got = grads[False][name]
        if name == "head.weight":
            assert got is None and want is None
            continue
        assert got is not None and got.dtype == torch.float32 and bool(got.abs().max() > 0), name
        _close(got, want, 1e-3, name)


def test_mlm_bf16_compute_keeps_fp32_masters_and_gradients(dev):
    model, gen = _mlm_model(dev, 7, dtype="bfloat16")
    batch = _mlm_batch(dev, gen)
    loss = mlm_loss_fn(model, batch, remat=True)
    loss.backward()
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert name == "head.weight" or p.grad.dtype == torch.float32, name


# ------------------------------------------- the fused decode route, B.10-B.13

PREP_REL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
BLOCK_REL = {torch.float32: 3e-5, torch.bfloat16: 1e-2}


def _att_prep_args(dev, dtype, pdtype, rng, B, C, D, Dd):
    p = lambda *shape, **kw: _on(dev, pdtype, rng, *shape, **kw)
    return (_on(dev, dtype, rng, B, C), _on(dev, torch.float32, rng, B, C),
            p(C, scale=0.1, loc=1.0), p(C, scale=0.1), p(6, C, scale=0.5),
            _on(dev, dtype, rng, C, 5 * D, scale=0.05), _on(dev, dtype, rng, 5, D, C, scale=0.1),
            p(C, Dd, scale=0.05), p(Dd, C, scale=0.1), p(C))


def _ffn_args(dev, dtype, pdtype, rng, B, C, F=None):
    p = lambda *shape, **kw: _on(dev, pdtype, rng, *shape, **kw)
    maa = lambda: torch.from_numpy(rng.uniform(size=C).astype(np.float32)).to(dev, pdtype)
    args = (_on(dev, dtype, rng, B, C), _on(dev, torch.float32, rng, B, C),
            p(C, scale=0.1, loc=1.0), p(C, scale=0.1), maa(), maa())
    if F is not None:
        args += tuple(_on(dev, dtype, rng, *shape, scale=0.03) for shape in ((F, C), (C, F), (C, C)))
    return args


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype,pdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B", [1, 2, 7, 8, 9, 64, 67, 130])
@pytest.mark.parametrize("C,D,Dd", [(2048, 32, 64), (256, 8, 16), (4096, 64, 128), (768, 32, 64),
                                    (2560, 32, 64)])
def test_att_prep_kernel(dev, dtype, pdtype, B, C, D, Dd):
    """B.10 at B=1, odd and even row counts (a row-pair block takes two rows,
    a cluster up to eight: 8, 9, 64, 67 and 130 fill, cross and exceed its
    row groups) and the widths of the 1B6, a small, the 7B, the 0.1B and the
    3B configuration; parameters in the compute dtype or kept in fp32
    (master weights). bf16 with bf16 parameters runs the cluster body, held
    also against its plain mirror (att_prep_sliced_plain)."""
    rng = np.random.default_rng(B + C)
    args = _att_prep_args(dev, dtype, pdtype, rng, B, C, D, Dd)
    got = _counted("att_prep_fused", lambda: att_prep_fused(*args))
    want = att_prep_plain(*args)
    assert [g.dtype for g in got] == [dtype] * 4 + [torch.float32] * 2
    for name, g, w in zip(("xr", "xk", "xv", "xg", "w", "xn"), got, want):
        assert g.shape == (B, C)
        _close(g, w, PREP_REL[dtype], name)
    assert _same_bits(got, att_prep_fused(*args))
    if b10_body(dtype, C, D, Dd, pdtype) == "cluster":
        for name, g, w in zip(("xr", "xk", "xv", "xg", "w", "xn"), got,
                              att_prep_sliced_plain(*args)):
            _close(g, w, PREP_REL[dtype], f"{name} against the sliced mirror")
        assert _same_bits(got, _launch_att_prep(*args, body="cluster"))


@pytest.mark.parametrize("B", [1, 9, 64])
def test_att_prep_bodies_agree(dev, B):
    """The cluster body against the row-pair body on the same bf16 inputs at
    the 1B6 widths: both within one bf16 rounding of the plain version."""
    rng = np.random.default_rng(B + 5)
    args = _att_prep_args(dev, torch.bfloat16, torch.bfloat16, rng, B, 2048, 32, 64)
    cluster = _launch_att_prep(*args, body="cluster")
    rows = _launch_att_prep(*args, body="row_pairs")
    for name, g, w in zip(("xr", "xk", "xv", "xg", "w", "xn"), cluster, rows):
        _close(g, w, 2 * PREP_REL[torch.bfloat16], name)


@pytest.mark.parametrize("dtype,pdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B,C", [(1, 2048), (7, 2050), (67, 256), (3, 7)])
def test_ffn_prep_kernel(dev, dtype, pdtype, B, C):
    rng = np.random.default_rng(B * C)
    args = _ffn_args(dev, dtype, pdtype, rng, B, C)
    got = _counted("ffn_prep_fused", lambda: ffn_prep_fused(*args))
    for name, g, w in zip(("xk", "xr", "xn"), got, ffn_prep_plain(*args)):
        assert g.shape == (B, C)
        _close(g, w, PREP_REL[dtype], name)
    assert got[0].dtype == got[1].dtype == dtype and got[2].dtype == torch.float32
    assert _same_bits(got, ffn_prep_fused(*args))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 7, 8, 9, 16, 17, 64, 67, 130])
@pytest.mark.parametrize("C,F", [(2048, 7168), (256, 896), (96, 160), (768, 2688), (2560, 8960),
                                 (4096, 14336)])
def test_ffn_block_kernel(dev, dtype, B, C, F):
    """B.12: B=1, row counts around its batch tiles (16 rows up to B=16, then
    64), more rows than one block owns, widths that are multiples of 32 only
    (a last k stage of 32), and the 0.1B, 1B6, 3B and 7B widths. bf16 is also
    held against the plain mirror of its split (ffn_block_split_plain)."""
    rng = np.random.default_rng(B + F)
    args = _ffn_args(dev, dtype, dtype, rng, B, C, F)
    out, xn = _counted("ffn_block_fused", lambda: ffn_block_fused(*args))
    want_out, want_xn = ffn_block_plain(*args)
    assert out.dtype == dtype and out.shape == (B, C) and xn.dtype == torch.float32
    _close(out, want_out, BLOCK_REL[dtype], "out")
    _close(xn, want_xn, PREP_REL[torch.float32], "xn")
    assert _same_bits((out, xn), ffn_block_fused(*args))
    if dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert _lib.library().rwkv_ffn_value_splits(C, F, sms) == ffn_value_splits(C, F, sms)
        mirror, _ = ffn_block_split_plain(*args, splits=ffn_value_splits(C, F, sms))
        _close(out, mirror, BLOCK_REL[dtype], "out against the split mirror")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("B", [1, 3, 64])
def test_wkv6_decode_transposed_kernel(dev, dtype, N, B):
    """B.13 against the plain version and against B.9: the new state is
    B.9's bit for bit after a transpose (the same fmaf per element), the
    output differs by the order of y's sum; in place as B.9."""
    rng = np.random.default_rng(B * N + 1)
    H, eps = 4, 6.4e-4
    C = H * N
    r, k, v, g = (_on(dev, dtype, rng, B, C) for _ in range(4))
    w = torch.from_numpy(rng.uniform(-8, 2.5, size=(B, C)).astype(np.float32)).to(dev)
    u = _on(dev, dtype, rng, H, N, scale=0.5)
    sc, bi = _on(dev, dtype, rng, C, scale=0.1, loc=1.0), _on(dev, dtype, rng, C, scale=0.1)
    state = _on(dev, torch.float32, rng, B, H, N, N, scale=0.3)
    args = (r, k, v, w, g, u, sc, bi)
    want_out, want_s = wkv6_decode_step_plain(*(a.float() for a in args), state, eps=eps)
    b9_out, b9_s = wkv6_decode_step(*args, state, eps=eps)
    buf = transpose_state(state)
    out, s_t = _counted("wkv6_decode_step_transposed", lambda: wkv6_decode_step_transposed(
        *args, buf, eps=eps, out_state=buf))
    assert s_t.data_ptr() == buf.data_ptr() and out.dtype == dtype and out.shape == (B, C)
    _close(out, want_out, REL[dtype])
    _close(transpose_state(s_t), want_s, 1e-5)
    assert torch.equal(transpose_state(s_t), b9_s)
    _close(out, b9_out, REL[dtype])
    fresh_out, fresh_s = wkv6_decode_step_transposed(*args, transpose_state(state), eps=eps)
    assert torch.equal(fresh_out, out) and torch.equal(fresh_s, s_t)


@pytest.mark.parametrize("in_place", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("B", [1, 2, 63, 64, 130])
def test_wkv6_decode_transposed_stream_body(dev, dtype, N, B, in_place):
    """B.13's persistent grid at C=2048 (from one head a block up to walks
    of many heads a block, ragged at B=63 and 130): against the plain
    version within the limits of test_wkv6_decode_transposed_kernel, its
    state B.9's bit for bit after a transpose, two calls bit-equal, in place
    and not; with u, ln_scale and ln_bias in fp32 (the kernels' other
    parameter dtype) B.13 and B.9 give the same bits as with them in
    ``dtype``."""
    rng = np.random.default_rng(B * N + 2)
    H, eps = 2048 // N, 6.4e-4
    C = H * N
    r, k, v, g = (_on(dev, dtype, rng, B, C) for _ in range(4))
    w = torch.from_numpy(rng.uniform(-8, 2.5, size=(B, C)).astype(np.float32)).to(dev)
    u = _on(dev, dtype, rng, H, N, scale=0.5)
    sc, bi = _on(dev, dtype, rng, C, scale=0.1, loc=1.0), _on(dev, dtype, rng, C, scale=0.1)
    state = _on(dev, torch.float32, rng, B, H, N, N, scale=0.3)
    args = (r, k, v, w, g, u, sc, bi)
    want_out, want_s = wkv6_decode_step_plain(*(a.float() for a in args), state, eps=eps)
    b9 = wkv6_decode_step(*args, state, eps=eps)
    buf = transpose_state(state)
    out_state = buf if in_place else None
    got = _counted("wkv6_decode_step_transposed", lambda: wkv6_decode_step_transposed(
        *args, buf, eps=eps, out_state=out_state))
    out, s_t = got
    assert (s_t.data_ptr() == buf.data_ptr()) == in_place
    assert out.dtype == dtype and out.shape == (B, C) and s_t.shape == (B, H, N, N)
    _close(out, want_out, REL[dtype], "out")
    _close(transpose_state(s_t), want_s, 1e-5, "state")
    assert torch.equal(transpose_state(s_t), b9[1])
    assert _same_bits(got, wkv6_decode_step_transposed(*args, transpose_state(state), eps=eps))
    f32_params = (*args[:5], u.float(), sc.float(), bi.float())
    assert _same_bits(got, wkv6_decode_step_transposed(*f32_params, transpose_state(state), eps=eps))
    assert _same_bits(b9, wkv6_decode_step(*f32_params, state, eps=eps))


def test_stream_body_grid_fits_the_card(dev):
    """The card holds at least one block of B.13 an SM for every dtype,
    parameter dtype and N (the ring fits), four at N=64; the grid the
    wrapper passes is b13_grid of that."""
    lib = _lib.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in DTYPES:
        for pdtype in DTYPES:
            for N in (16, 32, 64):
                per_sm = lib.rwkv_wkv6_decode_stream_blocks_per_sm(
                    _lib.DTYPE_CODES[dtype], _lib.DTYPE_CODES[pdtype], N)
                assert per_sm >= (4 if N == 64 else 1), (dtype, pdtype, N, per_sm)
                assert b13_grid(64 * 2048 // N, per_sm, sms) == min(64 * 2048 // N, per_sm * sms)


def test_stream_body_refuses_unaligned_vectors_by_name(dev):
    rng = np.random.default_rng(11)
    B, H, N = 2, 4, 64
    C = H * N
    r = _on(dev, torch.bfloat16, rng, B * C + 1)[1:].view(B, C)     # 2 bytes past 16
    k, v, g = (_on(dev, torch.bfloat16, rng, B, C) for _ in range(3))
    w = _on(dev, torch.float32, rng, B, C)
    u, sc, bi = _on(dev, torch.float32, rng, H, N), _on(dev, torch.float32, rng, C), _on(
        dev, torch.float32, rng, C)
    state = transpose_state(_on(dev, torch.float32, rng, B, H, N, N))
    before = launch_counts()["wkv6_decode_step_transposed"]
    with pytest.raises(ValueError, match="B.13 reads r by bulk copies"):
        wkv6_decode_step_transposed(r, k, v, w, g, u, sc, bi, state, eps=1e-5)
    assert launch_counts()["wkv6_decode_step_transposed"] == before


@pytest.mark.parametrize("dtype,pdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B", [1, 64, 130])
@pytest.mark.parametrize("C", [100, 264, 2048])
def test_ffn_prep_one_round_trip_body(dev, dtype, pdtype, B, C):
    """B.11's body at C that is not a multiple of 8 (its generic path), a
    multiple of 8 that leaves most of a warp idle, and the 1B6 width: within
    PREP_REL of the plain version and of the mirror of its sums' order,
    bit-equal twice; a row that starts 2 bytes past a 16-byte boundary takes
    the generic path and gives the same values."""
    rng = np.random.default_rng(B + C)
    args = _ffn_args(dev, dtype, pdtype, rng, B, C)
    got = _counted("ffn_prep_fused", lambda: ffn_prep_fused(*args))
    for want, what in ((ffn_prep_plain(*args), "plain"), (ffn_prep_warp_order_plain(*args), "mirror")):
        for name, g, w in zip(("xk", "xr", "xn"), got, want):
            assert g.shape == (B, C)
            _close(g, w, PREP_REL[dtype], f"{name} against the {what}")
    assert _same_bits(got, ffn_prep_fused(*args))
    x = torch.empty(B * C + 1, dtype=dtype, device=dev)[1:].view(B, C)
    x.copy_(args[0])
    shifted = ffn_prep_fused(x, *args[1:])
    for name, g, w in zip(("xk", "xr", "xn"), shifted, ffn_prep_plain(*args)):
        _close(g, w, PREP_REL[dtype], f"{name}, misaligned x")


@pytest.mark.parametrize("name", ["att_prep", "ffn_prep", "ffn_block", "decode", "decode_transposed"])
def test_recompute_backward_on_the_card(dev, name):
    """Under grad the wrappers launch their kernel forward and differentiate
    through the plain version: outputs are the kernel's, gradients equal
    autograd through the plain version on the same inputs."""
    rng = np.random.default_rng(7)
    f32 = torch.float32
    if name == "att_prep":
        args = _att_prep_args(dev, f32, f32, rng, 5, 256, 8, 16)
        fused, plain, counter, rel = att_prep_fused, att_prep_plain, "att_prep_fused", 2e-5
    elif name == "ffn_prep":
        args = _ffn_args(dev, f32, f32, rng, 5, 256)
        fused, plain, counter, rel = ffn_prep_fused, ffn_prep_plain, "ffn_prep_fused", 2e-5
    elif name == "ffn_block":
        args = _ffn_args(dev, f32, f32, rng, 5, 256, 512)
        fused, plain, counter, rel = ffn_block_fused, ffn_block_plain, "ffn_block_fused", 3e-5
    else:
        B, H, N, eps = 3, 2, 64, 6.4e-4
        C = H * N
        state = _on(dev, f32, rng, B, H, N, N, scale=0.3)
        args = tuple(_on(dev, f32, rng, B, C) for _ in range(3)) + (
            torch.from_numpy(rng.uniform(-8, 2.5, size=(B, C)).astype(np.float32)).to(dev),
            _on(dev, f32, rng, B, C), _on(dev, f32, rng, H, N, scale=0.5),
            _on(dev, f32, rng, C, scale=0.1, loc=1.0), _on(dev, f32, rng, C, scale=0.1),
            transpose_state(state) if name == "decode_transposed" else state)
        step = wkv6_decode_step_transposed if name == "decode_transposed" else wkv6_decode_step
        fused = lambda *a: step(*a, eps=eps)
        if name == "decode_transposed":
            def plain(*a):
                out, s = wkv6_decode_step_plain(*a[:-1], a[-1].transpose(-1, -2), eps=eps)
                return out, s.transpose(-1, -2)
        else:
            plain = lambda *a: wkv6_decode_step_plain(*a, eps=eps)
        counter, rel = step.__name__, 1e-4
    leaves = [a.detach().clone().requires_grad_() for a in args]
    ref_leaves = [a.detach().clone().requires_grad_() for a in args]
    before = launch_counts()[counter]
    outs = fused(*leaves)
    assert launch_counts()[counter] == before + 1
    assert all(o.grad_fn is not None for o in outs)
    ref_outs = plain(*ref_leaves)
    cts = [_on(dev, f32, rng, *o.shape) for o in outs]
    for o, w in zip(outs, ref_outs):
        _close(o, w, rel)
    got = torch.autograd.grad(list(outs), leaves, cts, allow_unused=True)
    want = torch.autograd.grad(list(ref_outs), ref_leaves, cts, allow_unused=True)
    assert launch_counts()[counter] == before + 1      # the backward launches nothing
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert (g_ is None) == (w_ is None), i
        if w_ is not None:
            _close(g_, w_, 1e-6, f"gradient {i}", scale=max(w_.abs().max().item(), 1e-30))


def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    before = launch_counts()
    rng = np.random.default_rng(9)
    f32 = torch.float32
    with pytest.raises(ValueError, match="multiples of 8"):
        att_prep_fused(*_att_prep_args(dev, f32, f32, rng, 2, 64, 4, 8))
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="cluster body takes"):
        _launch_att_prep(*_att_prep_args(dev, bf, bf, rng, 2, 64, 8, 8), body="cluster")
    with pytest.raises(ValueError, match="cluster body takes"):
        _launch_att_prep(*_att_prep_args(dev, bf, f32, rng, 2, 2048, 32, 64), body="cluster")
    with pytest.raises(ValueError, match="body must be one of"):
        _launch_att_prep(*_att_prep_args(dev, bf, bf, rng, 2, 2048, 32, 64), body="tiles")
    with pytest.raises(ValueError, match="multiples of 32"):
        ffn_block_fused(*_ffn_args(dev, f32, f32, rng, 2, 48, 96))
    args = _ffn_args(dev, f32, f32, rng, 2, 64, 128)
    with pytest.raises(ValueError, match="out, in"):
        ffn_block_fused(*args[:6], args[7], args[6], args[8])
    with pytest.raises(ValueError, match="shift"):
        ffn_prep_fused(args[0], args[1][:1], *args[2:6])
    r = torch.zeros(1, 96, device=dev)
    with pytest.raises(ValueError, match="head size"):
        wkv6_decode_step_transposed(
            r, r, r, r, r, torch.zeros(2, 48, device=dev), torch.ones(96, device=dev),
            torch.zeros(96, device=dev), torch.zeros(1, 2, 48, 48, device=dev), eps=1e-3)
    assert launch_counts() == before


def _decode_model(dev, seed, quant=None, dtype="float32"):
    cfg = ModelConfig(n_layer=2, n_embd=256, vocab_size=1000, head_size=64, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = init_rwkv_params(cfg, generator=gen, device=dev)
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen, device=dev) * 0.5 / sd[key].shape[1] ** 0.5
    model = load_state_dict_into(RWKV(cfg, device=dev), sd)
    if quant:
        quantize_model(model, quant)
    return model, gen


@pytest.mark.parametrize("quant", [None, "int8", "int8c"])
@pytest.mark.parametrize("B", [1, 3])
def test_model_fused_decode_route_matches_plain_route(dev, quant, B):
    """rwkv_decode_step(fused_prep=True) on a 2-layer fp32 model, in place:
    the kernel route against the plain route, logits and state, and against
    the unfused route; the launches of one step (dense leaves take B.12,
    quantized ones B.11; K2 and K3's ln2 calls are gone)."""
    model, gen = _decode_model(dev, 2, quant)
    tokens = torch.randint(4, 1000, (B, 20), generator=gen, device=dev)
    with torch.inference_mode():
        _, state = model(tokens[:, :12])
        plain_state = {k: v.clone() for k, v in state.items()}
        unfused_state = {k: v.clone() for k, v in state.items()}
        for t in range(12, 20):
            before = launch_counts()
            got, state = rwkv_decode_step(model, tokens[:, t], state, out=state, fused_prep=True)
            after = launch_counts()
            want, plain_state = rwkv_decode_step(model, tokens[:, t], plain_state, reference=True,
                                                 fused_prep=True)
            assert launch_counts() == after
            assert {k: after[k] - before[k] for k in after} == dict(
                NO_LAUNCH, layer_norm=2, att_prep_fused=2, wkv6_decode_step=2,
                ffn_block_fused=0 if quant else 2, ffn_prep_fused=2 if quant else 0,
                quantize_rows=16 if quant == "int8c" else 0)
            unfused, unfused_state = rwkv_decode_step(model, tokens[:, t], unfused_state,
                                                      out=unfused_state)
            _close(got, want, 1e-4)
            if quant != "int8c":     # int8c turns an fp32 rounding into a quantization step
                _close(got, unfused, 1e-4)
    for key in state:
        _close(state[key], plain_state[key], 1e-4)


def test_model_fused_decode_route_bf16_stays_close_to_unfused(dev):
    """In bf16 the fused route keeps the shift rows and xw unrounded: logits
    within a few bf16 roundings of the unfused route's, cosine >= 0.999 (the
    limit every bf16 route is held to), the state within 5e-2 of its largest
    value after 8 steps."""
    model, gen = _decode_model(dev, 3, dtype="bfloat16")
    tokens = torch.randint(4, 1000, (4, 20), generator=gen, device=dev)
    with torch.inference_mode():
        _, state = model(tokens[:, :12])
        other = {k: v.clone() for k, v in state.items()}
        for t in range(12, 20):
            fused, state = rwkv_decode_step(model, tokens[:, t], state, out=state, fused_prep=True)
            unfused, other = rwkv_decode_step(model, tokens[:, t], other, out=other)
            cos = torch.nn.functional.cosine_similarity(fused.double(), unfused.double(), dim=-1)
            assert float(cos.min()) >= 0.999
    for key in state:
        _close(state[key], other[key], 5e-2)


def _prologue_args(dev, rng, B, T, C, D):
    dtype = torch.bfloat16
    args = (
        _on(dev, dtype, rng, B, T, C), _on(dev, dtype, rng, B, C),
        _on(dev, dtype, rng, C, scale=0.2, loc=1.0), _on(dev, dtype, rng, C, scale=0.2),
        torch.from_numpy(rng.uniform(0, 1, size=(6, C)).astype(np.float32)).to(dev, dtype),
        _on(dev, dtype, rng, C, 5 * D, scale=0.1), _on(dev, dtype, rng, 5, D, C, scale=0.1),
    )
    return args, [_on(dev, dtype, rng, B, T, C) for _ in range(6)]


@pytest.mark.parametrize("C,D", [(64, 32), (128, 64), (2048, 32)])
@pytest.mark.parametrize("T", [1, 17, 63, 64, 65, 130])
@pytest.mark.parametrize("B", [1, 3])
def test_b5_bodies_on_row_tiles_that_straddle_sequences(dev, B, T, C, D):
    """Both bodies of B.5 on the same bf16 inputs, both forms, one cotangent
    None (dxln, as in the model) and three (dxk, dxr, dxln): each against
    autograd through the plain version (2e-2, BWD_REL), to each other (2e-2)
    and bit-equal twice; the tensor-core body against its tiled mirror on the
    same operand rounding, dx within one bf16 rounding (1e-2) and the fp32
    gradients within 1e-4 (the order of fp32 sums). Tiles of 31 owned rows
    straddle sequences at every T here but T = 1 with B = 1."""
    assert b5_body(torch.bfloat16, C, D) == "tensor_cores"
    assert b5_body(torch.float32, C, D) == "cuda_cores" == b5_body(torch.bfloat16, C + 4, D)
    rng = np.random.default_rng(B * 1000 + T * 10 + D)
    args, cts = _prologue_args(dev, rng, B, T, C, D)
    for missing in ((5,), (1, 3, 5)):
        c = [None if i in missing else ct for i, ct in enumerate(cts)]
        want = tmix_prologue_bwd_plain(*_f32(*args), _f32(*c))
        got = {}
        for body in B5_BODIES:
            got[body] = _counted("tmix_prologue_bwd", lambda: tmix_prologue_bwd(*args, c, body=body))
            again = tmix_prologue_bwd(*args, c, body=body)
            dx_only = tmix_prologue_bwd(*args, c, weights=False, body=body)
            assert torch.equal(dx_only[0], got[body][0]) and torch.equal(dx_only[1], got[body][1])
            for g, a, w in zip(got[body], again, want):
                assert g.shape == w.shape and torch.equal(g, a), body
                _close(g, w, BWD_REL[torch.bfloat16], body)
        for g, o in zip(got["tensor_cores"], got["cuda_cores"]):
            _close(g, o, BWD_REL[torch.bfloat16], "tensor cores vs CUDA cores")
        mirror = tmix_prologue_bwd_tiled_plain(*args, c)
        for i, (g, m) in enumerate(zip(got["tensor_cores"], mirror)):
            _close(g, m, REL[torch.bfloat16] if i == 0 else 1e-4, f"vs mirror {i}")


@pytest.mark.parametrize("T", [1, 15, 16, 17, 37, 512])
@pytest.mark.parametrize("decay", ["wide", "strong", "none"])
@pytest.mark.parametrize("N", [32, 64])
def test_wkv_bodies_chunks_decays_and_walks(dev, N, decay, T):
    """Both bodies of B.8 on the same bf16 inputs: w in [-8, 3], [2.5, 3.2]
    (a decay of 5e-6 .. 2e-11 a step) and -8 (none); with and without u and
    s0, forwards, in reverse, over ragged prefixes (0, 1, T - 2). Each against
    wkv_plain (chunked 1e-4, sequential 2e-5), the two against each other
    (1e-4), bit-equal twice, zeros beyond the prefix; the chunked body
    against its mirror in plain PyTorch (1e-4)."""
    assert wkv_body(torch.bfloat16, N) == "chunked" and wkv_body(torch.float32, N) == "sequential"
    lo, hi = {"wide": (-8.0, 3.0), "strong": (2.5, 3.2), "none": (-8.0, -8.0)}[decay]
    rng = np.random.default_rng(T * 7 + N)
    c = _wkv_case(dev, torch.bfloat16, rng, 3, T, 4, N)
    w = torch.from_numpy(rng.uniform(lo, hi, size=(3, T, 4, N)).astype(np.float32)).to(dev)
    lengths = torch.tensor([0, min(1, T), max(T - 2, 1)], dtype=torch.int32, device=dev)
    for u, s0, reverse, ln in ((c["u"], c["s0"], False, None), (None, None, False, None),
                               (None, c["s0"], True, lengths), (c["u"], None, False, lengths),
                               (c["u"], c["s0"], True, None)):
        kw = dict(reverse=reverse, lengths=ln)
        args = (c["r"], c["k"], c["v"], w, u, s0)
        py, psT = wkv_plain(*_f32(*args), **kw)
        got = {}
        for body in WKV_BODIES:
            got[body] = _counted("wkv", lambda: wkv(*args, body=body, **kw))
            again = wkv(*args, body=body, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got[body], again)), body
            rel = WKV_CHUNKED_REL if body == "chunked" else WKV_REL
            _close(got[body][0], py, rel, f"{body} y")
            _close(got[body][1], psT, rel, f"{body} sT")
            if ln is not None:
                beyond = torch.arange(T, device=dev)[None, :] >= ln[:, None]
                assert not beyond.any() or float(got[body][0][beyond].abs().max()) == 0.0
        for a, b in zip(got["chunked"], got["sequential"]):
            _close(a, b, WKV_CHUNKED_REL, "chunked vs sequential")
        my, msT = wkv_chunked_plain(*_f32(*args), **kw)
        _close(got["chunked"][0], my, WKV_CHUNKED_REL, "y vs mirror")
        _close(got["chunked"][1], msT, WKV_CHUNKED_REL, "sT vs mirror")


def test_new_bodies_at_the_1b6_widths(dev):
    """B=8, T=512: B.5 at C=2048, D=32 (both forms) and B.8 at H=32, N=64
    (forwards, and in reverse over ragged prefixes), each new body against
    its plain version and against the old body."""
    rng = np.random.default_rng(16)
    args, cts = _prologue_args(dev, rng, 8, 512, 2048, 32)
    cts[5] = None
    want = tmix_prologue_bwd_plain(*_f32(*args), _f32(*cts))
    tc, cc = (tmix_prologue_bwd(*args, cts, body=b) for b in ("tensor_cores", "cuda_cores"))
    for g, o, w in zip(tc, cc, want):
        _close(g, w, BWD_REL[torch.bfloat16])
        _close(g, o, BWD_REL[torch.bfloat16])
    c = _wkv_case(dev, torch.bfloat16, rng, 8, 512, 32, 64)
    for kw in (dict(), dict(reverse=True, lengths=c["lengths"])):
        args = (c["r"], c["k"], c["v"], c["w"], c["u"], c["s0"])
        py, psT = wkv_plain(*_f32(*args), **kw)
        ch, sq = (wkv(*args, body=b, **kw) for b in ("chunked", "sequential"))
        for a, b, p in zip(ch, sq, (py, psT)):
            _close(a, p, WKV_CHUNKED_REL)
            _close(a, b, WKV_CHUNKED_REL)
