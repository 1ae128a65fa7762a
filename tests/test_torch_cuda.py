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

The PEFT paths: an int8c projection under grad launches B.4 once and gives
the plain route's output and straight-through dx bit for bit; LoRA over an
int8, nf4 or fp4 base and TBPTT over every parameter hold the model
gradient limit (TBPTT also against the full sequence's loss without
L2Wrap); the selective remat policies give remat on's gradients bit for
bit; a 4-bit model's decode blocks capture and equal the eager ones.

RWKV-5.x and RWKV-4: B.14 (wkv4) against wkv4_plain at ragged C, T = 1 to
130, a fresh state (pp = -1e38) and a carried one, k up to +60, fp32 and bf16
inputs (y <= 1e-4 / 1e-2 x max|plain|, the state <= 1e-4), in place as well;
K1 and B.9 on v5's constant decays (per channel and per head, in [-6, 1],
with a gate and with ones); 2-layer v5.0 / v5.2 / v4 models, kernel route
against plain route with the launches of a forward and of a step; their
decode blocks as graph replays bit-equal to the eager blocks (generate and
the batcher). Their training: B.14's backward kernel against autograd
through wkv4_plain (fp32 1e-4, bf16 2e-2 of max|plain|, the initial state's
gradient included, two calls bit-equal), and the 2-layer v5.2 / v4 models'
gradients, plain sequence and TBPTT, within the model gradient limit. Head
size 128: K1 with B.6 / B.7, B.8 with its backward and B.9 against their
plain versions.

Speculative decoding: B.15 (wkv6_collect, K1's function keeping the state
after every step) against its plain version at T = 1 to 33, B of 1 and 4,
head sizes 64 and 128, v5's constant decays and a strided state stack (out
<= REL[dtype] x max|plain|, states <= 1e-4); the 2-layer collect forward
kernel route against the plain route with its launches, and its selected
states against a prefix forward; speculative rounds as graph replays
bit-equal to the eager rounds (greedy and sampled, RWKV-6, 5.2 and an
RWKV-4 target on the re-prefill rollback), and fp32 greedy output equal to
the engine's.

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
from rwkv_lm_ext_tpu_torch.adapters.quant import (
    dequantize_int8,
    int8_product,
    quantize_linear,
    quantize_model,
)
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.heads import (
    init_classification_head,
    init_embedding_head,
    init_layer_norm,
)
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, PLAIN_OPS, RWKV
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
from rwkv_lm_ext_tpu_torch.ops.quant import (
    quantize_rows,
    quantize_rows_given,
    quantize_rows_given_plain,
    quantize_rows_plain,
)
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
from rwkv_lm_ext_tpu_torch.ops.wkv4 import wkv4, wkv4_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_collect import wkv6_collect, wkv6_collect_plain
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
from rwkv_lm_ext_tpu_torch.train.loop import (
    contrastive_loss_fn,
    cross_encoder_loss_fn,
    instructor_loss_fn,
    mlm_loss_fn,
    sft_loss_fn,
    simcse_loss_fn,
    tbptt_loss_fn,
)
from rwkv_lm_ext_tpu_torch.train.losses import causal_lm_loss

pytestmark = pytest.mark.cuda

REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]
NO_LAUNCH = {"layer_norm": 0, "tmix_prologue": 0, "wkv6_fused_output": 0, "wkv6_decode_step": 0,
             "quantize_rows": 0, "tmix_prologue_bwd": 0, "wkv6_bwd_forward_pass": 0,
             "wkv6_bwd_reverse_pass": 0, "wkv": 0, "wkv_bwd_state_pass": 0,
             "att_prep_fused": 0, "ffn_prep_fused": 0, "ffn_block_fused": 0,
             "wkv6_decode_step_transposed": 0, "wkv4": 0, "wkv4_bwd": 0, "wkv6_collect": 0,
             "quantize_rows_given": 0}


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
@pytest.mark.parametrize("shape", [(37, 2050), (1, 1024), (4, 3584), (2048, 1024), (3, 7)])
def test_quantize_rows_given_kernel_is_bit_equal(dev, dtype, shape):
    """B.4's given-scale entry against its plain version: at the whole
    rows' scales (where it gives quantize_rows' codes), at larger scales
    (another rank's slice set them), and on exact half-way ties (absmax 127
    makes the scale 1.0)."""
    rng = np.random.default_rng(shape[0])
    x = _on(dev, dtype, rng, *shape, scale=3.0)
    if shape[-1] >= 8:
        x[0, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5])
    q, sx = quantize_rows(x)
    for scale in (sx, sx * 1.37):
        got = _counted("quantize_rows_given", lambda: quantize_rows_given(x, scale))
        assert torch.equal(got, quantize_rows_given_plain(x, scale))
    assert torch.equal(quantize_rows_given(x, sx), q)


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


# -- CUDA-graph decode blocks: the engine's and the batcher's ---------------

def _eager_blocks(monkeypatch):
    """The engine's and the batcher's private eager block bodies in place of
    their graph replays, on the card."""
    from rwkv_lm_ext_tpu_torch.infer import continuous, engine

    monkeypatch.setattr(engine._Decoder, "_replay", engine._Decoder._block)
    monkeypatch.setattr(continuous.ContinuousBatcher, "_replay", lambda self, key, body: body())


def _states_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


GRAPH_GREEDY = dict(temperature=0.0, top_p=1.0, alpha_presence=0.0, alpha_frequency=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_generate_graph_blocks_are_bit_equal_to_eager_blocks(dev, dtype, fused, k, monkeypatch):
    """generate at block size k as CUDA-graph replays and as the eager
    block: the same tokens and the same final state (torch.equal), greedy,
    sampled and with a stop token inside a block."""
    from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams

    model, _ = _decode_model(dev, 40, dtype=dtype)
    eng = GenerationEngine(model, fused_prep=fused)
    prompt, n = [5, 9, 23, 411, 7], 2 * k + 3
    greedy = SamplingParams(**GRAPH_GREEDY, token_stop=())
    first = eng.generate(prompt, max_tokens=n, sampling=greedy, block_size=k)
    cases = [greedy, SamplingParams(temperature=1.0, top_p=0.9, token_stop=()),
             SamplingParams(**GRAPH_GREEDY, token_stop=(first[n // 2],))]
    graph = [eng.generate(prompt, max_tokens=n, sampling=sp, block_size=k, seed=3,
                          return_state=True) for sp in cases]
    assert all(d.graphs for d in eng._decoders.values())
    _eager_blocks(monkeypatch)
    for sp, (toks, state) in zip(cases, graph):
        e_toks, e_state = eng.generate(prompt, max_tokens=n, sampling=sp, block_size=k, seed=3,
                                       return_state=True)
        assert toks == e_toks and _states_equal(state, e_state), sp
    assert len(graph[2][0]) < n


def test_new_knobs_and_lengths_replay_the_captured_graphs(dev):
    """generate's knobs and budget are data in its decoder's buffers: once
    a length's graph is captured, requests with other temperatures, top_p,
    penalties, stop tokens and lengths replay it and capture nothing."""
    from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams

    model, _ = _decode_model(dev, 44, dtype="bfloat16")
    eng = GenerationEngine(model)
    eng.generate([5, 9], max_tokens=16, sampling=SamplingParams(token_stop=()), block_size=16)
    (dec,) = eng._decoders.values()
    graph = dec.graphs[16]
    for n, sp in ((5, SamplingParams(**GRAPH_GREEDY, token_stop=(3,))),
                  (21, SamplingParams(temperature=0.6, top_p=0.5, repetition_penalty=1.3)),
                  (40, SamplingParams(alpha_presence=1.0, alpha_frequency=0.5, token_stop=(0, 7)))):
        out = eng.generate([8, 2, 77], max_tokens=n, sampling=sp, block_size=16, seed=4)
        assert len(out) <= n
    assert list(eng._decoders.values()) == [dec] and dec.graphs == {16: graph}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("k", [1, 4, 16])
def test_batcher_graph_blocks_are_bit_equal_to_eager_blocks(dev, fused, k, monkeypatch):
    """The batcher (bf16, 4 slots, slot-LoRA adapters per request, greedy
    and sampled rows, stops and budgets) as graph replays and eagerly: the
    same outputs and the same final pool state."""
    from rwkv_lm_ext_tpu_torch.adapters.slot_lora import build_slot_lora
    from rwkv_lm_ext_tpu_torch.infer.continuous import ContinuousBatcher
    from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams

    model, gen = _decode_model(dev, 41, dtype="bfloat16")
    lc = LoraConfig(r=4, alpha=8.0)
    adapter = init_lora_params(model, lc, gen)
    for ab in adapter.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=gen, device=dev) * 0.05
    model, ids = build_slot_lora(model, {"a": adapter}, lc)
    eng = GenerationEngine(model, adapter_ids=ids, fused_prep=fused)
    greedy = SamplingParams(**GRAPH_GREEDY, token_stop=())
    reqs = [([5, 9, 23], 9, greedy, None), ([77, 3], 7, SamplingParams(top_p=0.9, token_stop=()), "a"),
            ([14, 60, 2, 8], 12, greedy, "a"), ([99], 5, SamplingParams(token_stop=(3, 7)), None),
            ([31, 8, 120], 10, greedy, None), ([6], 6, greedy, "a")]

    def run():
        batcher = ContinuousBatcher(eng, n_slots=4, sampling=greedy, block_size=k, seed=5)
        rids = [batcher.submit(p, max_tokens=m, sampling=sp, adapter=a) for p, m, sp, a in reqs]
        out = batcher.run()
        return [out[r] for r in rids], {key: v.clone() for key, v in batcher._state.items()}, batcher

    toks, state, batcher = run()
    assert batcher._graphs
    _eager_blocks(monkeypatch)
    e_toks, e_state, _ = run()
    assert toks == e_toks and _states_equal(state, e_state)
    assert [len(t) for i, t in enumerate(toks) if reqs[i][2] is greedy] == [9, 12, 10, 6]


def test_a_failing_capture_raises_instead_of_falling_back(dev, monkeypatch):
    """A decode block that reads a value back to the host cannot be
    captured: generate and the batcher raise on the card, with no eager
    fallback."""
    from rwkv_lm_ext_tpu_torch.infer import continuous, engine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams

    model, _ = _decode_model(dev, 42, dtype="bfloat16")
    greedy = SamplingParams(**GRAPH_GREEDY, token_stop=())

    def syncing(real):
        def sample(logits, *args, **kwargs):
            token, occ = real(logits, *args, **kwargs)
            token.sum().item()            # a host read: refused under capture
            return token, occ
        return sample

    monkeypatch.setattr(engine, "sample_token_rows", syncing(engine.sample_token_rows))
    monkeypatch.setattr(continuous, "sample_token_rows", syncing(continuous.sample_token_rows))
    with pytest.raises(RuntimeError):
        engine.GenerationEngine(model).generate([5, 9, 23], max_tokens=8, sampling=greedy,
                                                block_size=4)
    batcher = continuous.ContinuousBatcher(engine.GenerationEngine(model), n_slots=2,
                                           sampling=greedy, block_size=4)
    batcher.submit([5, 9, 23], max_tokens=8)
    with pytest.raises(RuntimeError):
        batcher.run()


def test_garbage_holding_a_graph_is_collected_before_a_capture(dev, monkeypatch):
    """An engine dropped in a reference cycle still holds its CUDA graphs;
    a garbage collection inside a later capture would destroy them there,
    which invalidates the capture. capture_graph collects first and keeps
    the collector off while it captures."""
    import gc
    import weakref

    from rwkv_lm_ext_tpu_torch.infer import engine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams

    model, _ = _decode_model(dev, 43, dtype="bfloat16")
    greedy = SamplingParams(**GRAPH_GREEDY, token_stop=())

    class Holder:
        pass

    holder = Holder()
    holder.cycle, holder.engine = holder, engine.GenerationEngine(model)
    holder.engine.generate([5, 9], max_tokens=4, sampling=greedy, block_size=4)
    assert any(d.graphs for d in holder.engine._decoders.values())
    alive = weakref.ref(holder)
    del holder
    seen = []
    real = engine._Decoder._block

    def block(self, k, gen):
        seen.append((gc.isenabled(), alive() is None))
        return real(self, k, gen)

    monkeypatch.setattr(engine._Decoder, "_block", block)
    engine.GenerationEngine(model).generate([5, 9], max_tokens=4, sampling=greedy, block_size=4)
    assert seen == [(False, True)] and gc.isenabled()


# ------------------------------- the contrastive and reranking trainers' steps


def _rows(dev, gen, B, T, end_id=1):
    """(B, T) rows ending in `end_id` at ragged lengths, pads after."""
    tokens = torch.randint(4, 1000, (B, T), generator=gen, device=dev)
    ends = torch.randint(T // 4, T, (B,), generator=gen, device=dev)
    pos = torch.arange(T, device=dev)[None, :]
    tokens[pos == ends[:, None]] = end_id
    tokens[pos > ends[:, None]] = 0
    return tokens


# loss, the batch's token fields, K3 launches of the head a field
CONTRASTIVE = {
    "cosent": (lambda m, b, **k: contrastive_loss_fn(m, b, loss="cosent", pooling="lasttoken", **k),
               ("query", "positive", "negative"), 0),
    "infonce": (lambda m, b, **k: contrastive_loss_fn(m, b, loss="infonce", **k),
                ("query", "positive", "negative"), 0),
    "simcse": (simcse_loss_fn, ("a", "b"), 0),
    "instructor": (instructor_loss_fn, ("query", "positive", "negative"), 1),
}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", sorted(CONTRASTIVE))
def test_contrastive_full_step_kernel_route_matches_plain_route(dev, name, remat):
    """A 2-layer full-parameter step of the causal model over fp32 master
    weights (``nli``, ``simcse``, ``instructor``): every gradient but the
    untied head's within 1e-3 * max|plain| of the plain route's, and the
    launches exact: each field's forward (again under remat), B.5 in its full
    form, B.6 and B.7 in every layer, and the instructor head's LayerNorm
    through K3."""
    loss_fn, fields, head_ln = CONTRASTIVE[name]
    model, gen = _model(dev, 11)
    for p in model.parameters():
        p.requires_grad_(True)
    if name == "instructor":
        model.dense = init_embedding_head(model.cfg, generator=gen, output_dim=96)
        model.ln_dense = init_layer_norm(96, device=dev)
    batch = {k: _rows(dev, gen, 3, 40) for k in fields}
    grads = {}
    for reference in (False, True):
        model.zero_grad(set_to_none=True)
        before = launch_counts()
        loss_fn(model, batch, remat=remat, reference=reference).backward()
        after = launch_counts()
        fwd, f = (2 if remat else 1), len(fields)
        assert {k: after[k] - before[k] for k in after} == (NO_LAUNCH if reference else dict(
            NO_LAUNCH, layer_norm=f * (3 * fwd + 1 + head_ln), tmix_prologue=2 * f * fwd,
            wkv6_fused_output=2 * f * fwd, tmix_prologue_bwd=2 * f, wkv6_bwd_forward_pass=2 * f,
            wkv6_bwd_reverse_pass=2 * f))
        grads[reference] = {n: p.grad for n, p in model.named_parameters()}
    for n, want in grads[True].items():
        got = grads[False][n]
        if n == "head.weight":
            assert got is None and want is None
            continue
        assert got is not None and bool(got.abs().max() > 0), n
        _close(got, want, 1e-3, n)


def test_cross_encoder_step_kernel_route_matches_plain_route(dev):
    """LoRA r=8 (B seeded) and the score head: their gradients against the
    plain route's (the score head's too), B.5 dx-only in layer 1 alone."""
    model, gen = _model(dev, 12)
    lc = LoraConfig(r=8, alpha=32.0)
    adapter = init_lora_params(model, lc, gen)
    for ab in adapter.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=gen, device=dev) * 0.05
    apply_lora(model, lc, adapter)
    model.score = init_classification_head(model.cfg, generator=gen)
    tokens = _rows(dev, gen, 4, 40, end_id=1)
    tokens[:, 3] = 2
    batch = {"input_ids": tokens, "labels": torch.tensor([0, 1, 1, 0], device=dev)}
    grads = {}
    for reference in (False, True):
        model.zero_grad(set_to_none=True)
        before = launch_counts()
        cross_encoder_loss_fn(model, batch, remat=False, reference=reference).backward()
        after = launch_counts()
        assert {k: after[k] - before[k] for k in after} == (NO_LAUNCH if reference else dict(
            NO_LAUNCH, layer_norm=4, tmix_prologue=2, wkv6_fused_output=2, tmix_prologue_bwd=1,
            wkv6_bwd_forward_pass=2, wkv6_bwd_reverse_pass=2))
        grads[reference] = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert len(grads[False]) == 2 * 8 * 2 + 1
    for n, want in grads[True].items():
        assert bool(grads[False][n].abs().max() > 0), n
        _close(grads[False][n], want, 1e-3, n)


# ---------------------------------------------------------------------------
# The rest of PEFT training: QLoRA, TBPTT, the remat policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_int8c_projection_under_grad_launches_b4_and_is_straight_through(dev, dtype):
    """QuantLinear int8c on an input that requires grad: B.4 once in the
    forward (on the detached input), none in the backward; output and dx
    bit-equal to the plain route's, dx = g @ dequantize(q, scale)."""
    gen = torch.Generator(device=dev).manual_seed(60)
    lin = quantize_linear(torch.randn(96, 160, device=dev, generator=gen) * 0.05, "int8c")
    x = torch.randn(3, 37, 160, device=dev, generator=gen).to(dtype)
    g = torch.randn(3, 37, 96, device=dev, generator=gen).to(dtype)
    outs = []
    for ops in (KERNEL_OPS, PLAIN_OPS):
        xr = x.clone().requires_grad_(True)
        before = launch_counts()["quantize_rows"]
        y = lin(xr, ops)
        y.backward(g)
        outs.append((y, xr.grad, launch_counts()["quantize_rows"] - before))
    (yk, dk, nk), (yp, dp, np_) = outs
    assert (nk, np_) == (1, 0)
    assert torch.equal(yk, yp) and torch.equal(dk, dp)
    assert torch.equal(dk, g @ dequantize_int8(lin.q, lin.scale, dtype))


@pytest.mark.parametrize("mode", ["int8", "nf4", "fp4"])
def test_qlora_grads_kernel_route_match_plain_route(dev, mode):
    """LoRA over a dequantized-on-use base (fp32): the kernel route's A/B
    gradients within 1e-3 of the plain route's."""
    model, gen = _model(dev, 61)
    quantize_model(model, mode)
    lc = LoraConfig(r=8, alpha=32.0)
    adapter = init_lora_params(model, lc, gen)
    for ab in adapter.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=gen, device=dev) * 0.05
    apply_lora(model, lc, adapter)
    tokens = torch.randint(4, 1000, (2, 45), generator=gen, device=dev)
    labels = torch.randint(4, 1000, (2, 45), generator=gen, device=dev)
    got = _grads(model, tokens, labels, reference=False, remat=True)
    want = _grads(model, tokens, labels, reference=True)
    assert len(got) == 2 * 8 * 2
    for name in want:
        assert bool(got[name].abs().max() > 0), name
        _close(got[name], want[name], 1e-3, name)


def test_tbptt_grads_kernel_route_match_plain_route_and_the_full_sequence(dev):
    """TBPTT over every parameter (chunks of 16 of T=64, fp32): the kernel
    route against the plain route within 1e-3, and against the full
    sequence's causal loss without L2Wrap on the kernel route within 1e-3;
    K1 launched 2 x 4 chunks x 2 layers (remat), B.6 and B.7 4 x 2."""
    model, gen = _model(dev, 62)
    tokens = torch.randint(4, 1000, (2, 64), generator=gen, device=dev)
    batch = {"input_ids": tokens, "labels": torch.randint(4, 1000, (2, 64), generator=gen, device=dev)}

    def grads(loss_fn):
        model.zero_grad()
        loss_fn().backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    before = launch_counts()
    got = grads(lambda: tbptt_loss_fn(model, batch, chunk_ctx=16, remat=True))
    after = launch_counts()
    assert {k: after[k] - before[k] for k in ("wkv6_fused_output", "wkv6_bwd_forward_pass",
                                              "wkv6_bwd_reverse_pass")} == {
        "wkv6_fused_output": 16, "wkv6_bwd_forward_pass": 8, "wkv6_bwd_reverse_pass": 8}
    plain = grads(lambda: tbptt_loss_fn(model, batch, chunk_ctx=16, reference=True))

    def whole():
        logits, _ = model(tokens, t1_step=False)
        return causal_lm_loss(logits, batch["labels"], l2_wrap=False)

    full = grads(whole)
    for name in plain:
        assert bool(got[name].abs().max() > 0), name
        _close(got[name], plain[name], 1e-3, name)
        _close(got[name], full[name], 1e-3, name)


@pytest.mark.parametrize("policy", ["dots", "dots_nobatch"])
def test_remat_policies_give_the_gradients_of_remat_on(dev, policy):
    """LoRA, bf16 compute, kernel route: a selective policy's gradients are
    remat on's, bit for bit, and it runs the blocks' kernels twice as on
    does (they launch outside the dispatcher, so no policy saves them)."""
    model, gen = _model(dev, 63)
    model = load_state_dict_into(RWKV(ModelConfig(n_layer=2, n_embd=256, vocab_size=1000,
                                                  head_size=64), device=dev), model.state_dict())
    lc = LoraConfig(r=8, alpha=32.0)
    adapter = init_lora_params(model, lc, gen)
    for ab in adapter.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=gen, device=dev) * 0.05
    apply_lora(model, lc, adapter)
    tokens = torch.randint(4, 1000, (2, 45), generator=gen, device=dev)
    labels = torch.randint(4, 1000, (2, 45), generator=gen, device=dev)
    on = _grads(model, tokens, labels, reference=False, remat=True)
    before = launch_counts()["wkv6_fused_output"]
    got = _grads(model, tokens, labels, reference=False, remat=policy)
    assert launch_counts()["wkv6_fused_output"] - before == 4
    assert all(torch.equal(got[n], on[n]) for n in on)


@pytest.mark.parametrize("mode", ["nf4", "fp4"])
def test_4bit_model_decodes_in_graph_blocks(dev, mode):
    """A 4-bit model's decode blocks capture (dequantizing copies nothing
    from the host) and give the eager blocks' greedy tokens."""
    from unittest import mock

    from rwkv_lm_ext_tpu_torch.infer import engine as engine_module
    from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams

    model, gen = _model(dev, 64)
    model = quantize_model(load_state_dict_into(RWKV(ModelConfig(
        n_layer=2, n_embd=256, vocab_size=1000, head_size=64), device=dev), model.state_dict()), mode)
    greedy = SamplingParams(temperature=0.0, top_p=1.0, alpha_presence=0.0, alpha_frequency=0.0,
                            token_stop=())
    prompt = torch.randint(4, 1000, (9,), generator=gen, device=dev).tolist()
    graphs = GenerationEngine(model, None).generate(prompt, max_tokens=20, sampling=greedy)
    with mock.patch.object(engine_module._Decoder, "_replay", engine_module._Decoder._block):
        eager = GenerationEngine(model, None).generate(prompt, max_tokens=20, sampling=greedy)
    assert len(graphs) == 20 and graphs == eager


# -- RWKV-5.x and RWKV-4: B.14, and K1 / B.9 on v5's decays --------------------

def _wkv4_inputs(dev, dtype, B, T, C, seed, carried):
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.uniform(-3.0, 60.0, size=(B, T, C)).astype(np.float32)).to(dev, dtype)
    v = _on(dev, dtype, rng, B, T, C)
    w = -torch.exp(_on(dev, torch.float32, rng, C))
    u = _on(dev, torch.float32, rng, C)
    state = None
    if carried:
        state = (_on(dev, torch.float32, rng, B, C), torch.exp(_on(dev, torch.float32, rng, B, C)),
                 _on(dev, torch.float32, rng, B, C, scale=5.0))
    return k, v, w, u, state


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T", [(1, 1), (3, 17), (2, 130)])
@pytest.mark.parametrize("carried", [False, True])
def test_wkv4_matches_plain(dev, dtype, B, T, carried):
    """B.14 at C = 200 (a ragged block of channels), from a fresh state
    (pp = -1e38) or a carried one, k up to +60."""
    k, v, w, u, state = _wkv4_inputs(dev, dtype, B, T, 200, seed=T + B, carried=carried)
    y, st = _counted("wkv4", lambda: wkv4(k, v, w, u, state))
    y_p, st_p = wkv4_plain(k, v, w, u, state)
    assert y.dtype == torch.float32 and torch.isfinite(y).all()
    _close(y, y_p, REL[dtype], "y")
    for name, a, b in zip(("aa", "bb", "pp"), st, st_p):
        _close(a, b, 1e-4, name)


def test_wkv4_in_place_and_refusals(dev):
    """out_state=state updates the state in place, bit-equal to a fresh
    output; two calls are bit-equal; under grad an out_state is refused (the
    new state is a result of the graph there)."""
    k, v, w, u, state = _wkv4_inputs(dev, torch.bfloat16, 4, 33, 256, seed=1, carried=True)
    y, fresh = wkv4(k, v, w, u, state)
    y2, _ = wkv4(k, v, w, u, state)
    inplace = tuple(s.clone() for s in state)
    y3, out = wkv4(k, v, w, u, inplace, out_state=inplace)
    assert all(o is i for o, i in zip(out, inplace))
    assert torch.equal(y, y2) and torch.equal(y, y3)
    assert all(torch.equal(a, b) for a, b in zip(out, fresh))
    with pytest.raises(ValueError, match="out_state is for inference"):
        wkv4(k.float().requires_grad_(), v.float(), w, u, state, out_state=inplace)


def _wkv4_grads(fn, k, v, w, u, state, gy, gs):
    leaves = [t.detach().clone().requires_grad_() for t in (k, v, w, u, *state)]
    y, fs = fn(*leaves[:4], tuple(leaves[4:]))
    ((y * gy).sum() + sum((a * b).sum() for a, b in zip(fs, gs))).backward()
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T", [(1, 1), (3, 17), (2, 130)])
@pytest.mark.parametrize("carried", [False, True])
def test_wkv4_backward_matches_autograd_through_plain(dev, dtype, B, T, carried):
    """B.14's backward kernel against autograd through wkv4_plain: dk, dv,
    dw, du and the initial state's gradient under gradients of y and of the
    final state (fp32 within 1e-4, bf16 within 2e-2 of max|plain|); two
    calls bit-equal; one forward and one backward launch a call."""
    k, v, w, u, state = _wkv4_inputs(dev, dtype, B, T, 200, seed=T + B, carried=carried)
    if state is None:
        state = tuple(s.to(dev) for s in (torch.zeros(B, 200), torch.zeros(B, 200),
                                          torch.full((B, 200), -1e38)))
    rng = np.random.default_rng(3)
    gy = _on(dev, torch.float32, rng, B, T, 200)
    gs = [_on(dev, torch.float32, rng, B, 200) for _ in range(3)]
    before = launch_counts()
    got = _wkv4_grads(wkv4, k, v, w, u, state, gy, gs)
    after = launch_counts()
    assert after["wkv4"] - before["wkv4"] == 1 and after["wkv4_bwd"] - before["wkv4_bwd"] == 1
    again = _wkv4_grads(wkv4, k, v, w, u, state, gy, gs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = _wkv4_grads(wkv4_plain, k, v, w, u, state, gy, gs)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    for name, a, b in zip(("y", "dk", "dv", "dw", "du", "daa", "dbb", "dpp"), got, want):
        assert torch.isfinite(a).all(), name
        _close(a, b, rel, name, scale=max(b.float().abs().max().item(), 1e-30))


def _v5_decay(dev, rng, H, N, per_head):
    shape = (H, 1) if per_head else (H, N)
    return torch.from_numpy(rng.uniform(-6.0, 1.0, size=shape).astype(np.float32)).to(dev).expand(H, N)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("gate", [True, False])
def test_k1_on_v5_decays_matches_plain(dev, dtype, per_head, gate):
    """K1 with v5's constant decay broadcast over (B, T) (an expanded w, as
    TimeMixV5 passes it) and a silu gate or ones (v5.0)."""
    rng = np.random.default_rng(7)
    B, T, H, N = 2, 67, 4, 64
    r, k, v = (_on(dev, dtype, rng, B, T, H, N, scale=0.5) for _ in range(3))
    w = _v5_decay(dev, rng, H, N, per_head).reshape(1, 1, H, N).expand(B, T, H, N)
    g = torch.nn.functional.silu(_on(dev, dtype, rng, B, T, H, N)) if gate else torch.ones_like(r)
    u = _on(dev, torch.float32, rng, H, N, scale=0.5)
    ln_w, ln_b = _on(dev, torch.float32, rng, H * N, loc=1.0, scale=0.1), _on(dev, torch.float32, rng, H * N, scale=0.1)
    s0 = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1)
    out, sT = _counted("wkv6_fused_output", lambda: wkv6_fused_output(
        r, k, v, w, u, g, ln_w, ln_b, s0, eps=64e-5))
    out_p, sT_p = wkv6_fused_output_plain(*[t.float() for t in (r, k, v)], w, u, g.float(),
                                          ln_w, ln_b, s0, eps=64e-5)
    _close(out, out_p, REL[dtype], "out")
    _close(sT, sT_p, 1e-4, "state")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("gate", [True, False])
def test_b9_on_v5_decays_matches_plain(dev, dtype, per_head, gate):
    """B.9 with v5's decay broadcast to (B, C), a gate or ones, in place."""
    rng = np.random.default_rng(8)
    B, H, N = 3, 4, 64
    C = H * N
    r, k, v = (_on(dev, dtype, rng, B, C, scale=0.5) for _ in range(3))
    w = _v5_decay(dev, rng, H, N, per_head).reshape(1, C).expand(B, C).contiguous()
    g = torch.nn.functional.silu(_on(dev, dtype, rng, B, C)) if gate else torch.ones_like(r)
    u = _on(dev, torch.float32, rng, H, N, scale=0.5)
    ln_w, ln_b = _on(dev, torch.float32, rng, C, loc=1.0, scale=0.1), _on(dev, torch.float32, rng, C, scale=0.1)
    state = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1)
    out_p, s_p = wkv6_decode_step_plain(*[t.float() for t in (r, k, v)], w, g.float(), u,
                                        ln_w, ln_b, state.clone(), eps=64e-5)
    out, s = _counted("wkv6_decode_step", lambda: wkv6_decode_step(
        r, k, v, w, g, u, ln_w, ln_b, state, eps=64e-5, out_state=state))
    assert s is state
    _close(out, out_p, REL[dtype], "out")
    _close(s, s_p, 1e-4, "state")


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_size_128_kernels_match_plain(dev, dtype):
    """K1 with B.6 / B.7 under grad, B.8 with its backward, and B.9 at N = 128
    (the sequential bodies; the backward's fp64 tile in 132 KB of dynamic
    shared memory) against their plain versions: fp32 outputs within 1e-4 and
    gradients 1e-3, bf16 2e-2, of max|plain|."""
    rng = np.random.default_rng(11)
    B, T, H, N = 2, 37, 2, 128
    r, k, v, g = (_on(dev, dtype, rng, B, T, H, N, scale=0.5) for _ in range(4))
    w = torch.from_numpy(rng.uniform(-3.0, 1.0, size=(B, T, H, N)).astype(np.float32)).to(dev)
    u = _on(dev, torch.float32, rng, H, N)
    ln_w, ln_b = _on(dev, torch.float32, rng, H * N, loc=1.0, scale=0.1), _on(dev, torch.float32, rng, H * N, scale=0.1)
    s0 = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1)
    dout = _on(dev, dtype, rng, B, T, H * N)
    dsT = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1)
    rel_out, rel_grad = (1e-4, 1e-3) if dtype == torch.float32 else (2e-2, 2e-2)
    for fn, plain, cot in ((wkv6_fused_output, wkv6_fused_output_plain, dout.float()),
                           (wkv, wkv_plain, dout.float().view(B, T, H, N))):
        res = []
        for f in (fn, plain):
            args = (r, k, v, w, u, g, ln_w, ln_b, s0) if f in (wkv6_fused_output,
                                                                 wkv6_fused_output_plain) \
                else (r, k, v, w, u, s0)
            leaves = [t.detach().clone().requires_grad_() for t in args]
            out, sT = f(*leaves, eps=64e-5) if len(args) == 9 else f(*leaves)
            ((out.float() * cot).sum() + (sT * dsT).sum()).backward()
            res.append([out.detach(), sT.detach()] + [t.grad for t in leaves])
        for i, (a, b) in enumerate(zip(*res)):
            _close(a, b, rel_out if i < 2 else rel_grad, f"{fn.__name__} {i}")
    rd, kd, vd, gd = (_on(dev, dtype, rng, 3, H * N, scale=0.5) for _ in range(4))
    wd = _on(dev, torch.float32, rng, 3, H * N)
    state = _on(dev, torch.float32, rng, 3, H, N, N, scale=0.1)
    out_p, s_p = wkv6_decode_step_plain(rd, kd, vd, wd, gd, u, ln_w, ln_b, state.clone(),
                                        eps=64e-5)
    out, s = _counted("wkv6_decode_step", lambda: wkv6_decode_step(
        rd, kd, vd, wd, gd, u, ln_w, ln_b, state, eps=64e-5, out_state=state))
    _close(out, out_p, REL[dtype], "B.9 out")
    _close(s, s_p, 1e-4, "B.9 state")


def _family_model(dev, seed, version, dtype="float32"):
    """A 2-layer RWKV-5.x or RWKV-4 model (C=256; v5 heads of 64) with the
    zero-initialised projections filled; v5.0 without a gate."""
    cfg = ModelConfig(n_layer=2, n_embd=256, vocab_size=1000, version=version, dtype=dtype,
                      head_size=256 if version < 5 else 64)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sd = init_rwkv_params(cfg, generator=gen, device=dev)
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen, device=dev) * 0.5 / sd[key].shape[1] ** 0.5
    if version == 5.0:
        sd = {k: v for k, v in sd.items() if not k.endswith(("att.gate.weight", "att.time_mix_g"))}
    return load_state_dict_into(RWKV(cfg, device=dev), sd), gen


@pytest.mark.parametrize("version", [5.2, 4.0])
@pytest.mark.parametrize("chunk", [0, 16])
def test_family_training_gradients_kernel_route_match_plain(dev, version, chunk):
    """Every parameter's gradient of the SFT loss (chunk 0) or of TBPTT over
    chunks of 16 (the state carried with its gradient), kernel route against
    plain route, fp32, within 1e-3 of each gradient's largest value; the v4
    step launches B.14's forward and backward once a layer and chunk."""
    model, gen = _family_model(dev, 53, version)
    tokens = torch.randint(4, 1000, (2, 48), generator=gen, device=dev)
    batch = {"input_ids": tokens, "labels": tokens}
    grads = []
    for reference in (False, True):
        model.zero_grad()
        before = launch_counts()
        if chunk:
            loss = tbptt_loss_fn(model, batch, chunk_ctx=chunk, remat=True, reference=reference)
        else:
            loss = sft_loss_fn(model, batch, remat=True, reference=reference)
        loss.backward()
        after = launch_counts()
        if version == 4.0 and not reference:
            n = 2 * (48 // chunk if chunk else 1)
            assert after["wkv4_bwd"] - before["wkv4_bwd"] == n
            assert after["wkv4"] - before["wkv4"] == 2 * n       # remat runs it again
        grads.append({n_: p.grad.clone() for n_, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for name in grads[1]:
        _close(grads[0][name], grads[1][name], 1e-3, name,
               scale=max(grads[1][name].abs().max().item(), 1e-30))


FAMILY_WKV = {5.0: "wkv6_fused_output", 5.2: "wkv6_fused_output", 4.0: "wkv4"}
FAMILY_STEP = {5.0: "wkv6_decode_step", 5.2: "wkv6_decode_step", 4.0: "wkv4"}


@pytest.mark.parametrize("version", [5.0, 5.2, 4.0])
def test_family_model_kernel_route_matches_plain_route(dev, version):
    """Logits and state of a forward and of an in-place decode step, kernel
    route against plain route (fp32, 1e-4 x max|plain|), with the launches
    of each: K3 for ln0, ln1, ln2 and ln_out (6 at 2 layers) and one WKV
    kernel a layer (K1 / B.9 for v5, B.14 for v4)."""
    model, gen = _family_model(dev, 50, version)
    tokens = torch.randint(4, 1000, (3, 45), generator=gen, device=dev)
    with torch.inference_mode():
        before = launch_counts()
        got, got_state = model(tokens)
        mid = launch_counts()
        want, want_state = model(tokens, reference=True)
        assert launch_counts() == mid
        _close(got, want, 1e-4, "logits")
        for key in want_state:
            _close(got_state[key], want_state[key], 1e-4, key)
        step_tok = tokens[:, 0]
        p_logits, p_state = rwkv_decode_step(model, step_tok, want_state, reference=True)
        mid = launch_counts()
        k_logits, k_state = rwkv_decode_step(model, step_tok, got_state, out=got_state)
        after = launch_counts()
    assert {k: mid[k] - before[k] for k in mid} == dict(
        NO_LAUNCH, layer_norm=6, **{FAMILY_WKV[version]: 2})
    assert {k: after[k] - mid[k] for k in after} == dict(
        NO_LAUNCH, layer_norm=6, **{FAMILY_STEP[version]: 2})
    _close(k_logits, p_logits, 1e-4, "step logits")
    for key in p_state:
        _close(k_state[key], p_state[key], 1e-4, key)


@pytest.mark.parametrize("version", [5.0, 5.2, 4.0])
@pytest.mark.parametrize("k", [1, 16])
def test_family_generate_graph_blocks_are_bit_equal_to_eager(dev, version, k, monkeypatch):
    """generate on a bf16 v5 / v4 model: graph replays (the aa, bb and pp
    buffers updated in place at every replay for v4) and eager blocks give
    the same tokens and final state, greedy and sampled."""
    from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams

    model, _ = _family_model(dev, 51, version, dtype="bfloat16")
    eng = GenerationEngine(model)
    prompt, n = [5, 9, 23, 411, 7], 2 * k + 3
    cases = [SamplingParams(**GRAPH_GREEDY, token_stop=()),
             SamplingParams(temperature=1.0, top_p=0.9, token_stop=())]
    graph = [eng.generate(prompt, max_tokens=n, sampling=sp, block_size=k, seed=3,
                          return_state=True) for sp in cases]
    assert all(d.graphs for d in eng._decoders.values())
    _eager_blocks(monkeypatch)
    for sp, (toks, state) in zip(cases, graph):
        e_toks, e_state = eng.generate(prompt, max_tokens=n, sampling=sp, block_size=k, seed=3,
                                       return_state=True)
        assert toks == e_toks and _states_equal(state, e_state), sp


@pytest.mark.parametrize("version", [5.2, 4.0])
def test_family_batcher_graph_blocks_are_bit_equal_to_eager(dev, version, monkeypatch):
    """The batcher on a bf16 v5.2 / v4 model, 6 requests over 4 slots (rows
    re-admitted: the state scatter on aa, bb and pp for v4): graph replays
    and eager blocks, the same outputs and final pool state."""
    from rwkv_lm_ext_tpu_torch.infer.continuous import ContinuousBatcher
    from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams

    model, _ = _family_model(dev, 52, version, dtype="bfloat16")
    eng = GenerationEngine(model)
    greedy = SamplingParams(**GRAPH_GREEDY, token_stop=())
    reqs = [([5, 9, 23], 9), ([77, 3], 7), ([14, 60, 2, 8], 12), ([99], 5), ([31, 8, 120], 10),
            ([6], 6)]

    def run():
        batcher = ContinuousBatcher(eng, n_slots=4, sampling=greedy, block_size=4, seed=5)
        rids = [batcher.submit(p, max_tokens=m) for p, m in reqs]
        out = batcher.run()
        return [out[r] for r in rids], {key: v.clone() for key, v in batcher._state.items()}, batcher

    toks, state, batcher = run()
    assert batcher._graphs
    _eager_blocks(monkeypatch)
    e_toks, e_state, _ = run()
    assert toks == e_toks and _states_equal(state, e_state)
    assert [len(t) for t in toks] == [m for _, m in reqs]


# ---------------------------------------------------------------------------
# B.15 and speculative decoding
# ---------------------------------------------------------------------------


def _collect_args(dev, dtype, rng, B, T, H, N, v5=False, gate=True):
    r, k, v = (_on(dev, dtype, rng, B, T, H, N, scale=0.5) for _ in range(3))
    if v5:
        w = _v5_decay(dev, rng, H, N, per_head=False).reshape(1, 1, H, N).expand(B, T, H, N)
    else:
        w = torch.from_numpy(rng.uniform(-6.0, 1.0, size=(B, T, H, N)).astype(np.float32)).to(dev)
    g = torch.nn.functional.silu(_on(dev, dtype, rng, B, T, H, N)) if gate else torch.ones_like(r)
    u = _on(dev, torch.float32, rng, H, N, scale=0.5)
    ln_w = _on(dev, torch.float32, rng, H * N, loc=1.0, scale=0.1)
    ln_b = _on(dev, torch.float32, rng, H * N, scale=0.1)
    s0 = _on(dev, torch.float32, rng, B, H, N, N, scale=0.1)
    return r, k, v, w, u, g, ln_w, ln_b, s0


def _collect_plain(args, eps):
    r, k, v, w, u, g, *rest = args
    return wkv6_collect_plain(r.float(), k.float(), v.float(), w, u, g.float(), *rest, eps=eps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [64, 128])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("T", [1, 5, 9, 17, 33])
def test_wkv_collect_kernel_matches_plain(dev, dtype, N, B, T):
    """B.15 against wkv_collect + K1's GroupNorm-gate epilogue: the gated
    output within REL[dtype] and every state within 1e-4 of max|plain|; two
    calls bit-equal."""
    rng = np.random.default_rng(1000 + 10 * T + B + N)
    args = _collect_args(dev, dtype, rng, B, T, 4 if N == 64 else 2, N)
    out, states = _counted("wkv6_collect", lambda: wkv6_collect(*args, eps=64e-5))
    assert out.dtype == dtype and states.shape == (T, B, args[0].shape[2], N, N)
    out_p, states_p = _collect_plain(args, 64e-5)
    _close(out, out_p, REL[dtype], "out")
    _close(states, states_p, 1e-4, "states")
    out2, states2 = wkv6_collect(*args, eps=64e-5)
    assert torch.equal(out, out2) and torch.equal(states, states2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gate", [True, False])
def test_wkv_collect_kernel_on_v5_decays_into_a_stack(dev, dtype, gate):
    """B.15 on v5's constant decay (expanded over B and T) with a gate or
    ones, writing layer 1 of a (T, L, B, H, N, N) stack in place; K1's output
    and final state on the same inputs."""
    rng = np.random.default_rng(77)
    B, T, H, N = 2, 9, 4, 64
    args = _collect_args(dev, dtype, rng, B, T, H, N, v5=True, gate=gate)
    stack = torch.zeros(T, 3, B, H, N, N, device=dev)
    out, states = wkv6_collect(*args, eps=64e-5, out_states=stack[:, 1])
    assert states.data_ptr() == stack[:, 1].data_ptr()
    assert stack[:, 0].abs().max() == 0 and stack[:, 2].abs().max() == 0
    out_p, states_p = _collect_plain(args, 64e-5)
    _close(out, out_p, REL[dtype], "out")
    _close(stack[:, 1], states_p, 1e-4, "states")
    k1_out, k1_state = wkv6_fused_output(*args, eps=64e-5)
    _close(out, k1_out, 2 * REL[dtype], "out vs K1")
    _close(states[-1], k1_state, 1e-4, "last state vs K1")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", [6.0, 5.2])
def test_collect_forward_kernel_route_matches_plain(dev, dtype, version):
    """The 2-layer collect forward on the kernel route against the plain
    route (logits within REL, states within 1e-4 of max|plain| in fp32), its
    launches (K3 x 4 (RWKV-5: 6), K2 x 2 on RWKV-6, B.15 x 2, no K1), and its
    selected state against the kernel route's prefix forward."""
    from rwkv_lm_ext_tpu_torch.models.collect import rwkv_forward_collect, select_state

    model, gen = (_decode_model(dev, 61, dtype=dtype) if version == 6.0
                  else _family_model(dev, 61, 5.2, dtype=dtype))
    tokens = torch.randint(0, 1000, (2, 9), generator=gen, device=dev)
    with torch.inference_mode():
        before = launch_counts()
        logits, states = rwkv_forward_collect(model, tokens)
        after = launch_counts()
        want = dict(NO_LAUNCH, layer_norm=4 if version == 6.0 else 6, wkv6_collect=2,
                    tmix_prologue=2 if version == 6.0 else 0)
        assert {k: after[k] - before[k] for k in after} == want
        p_logits, p_states = rwkv_forward_collect(model, tokens, reference=True)
        assert launch_counts() == after
        rel = REL[getattr(torch, dtype)]
        _close(logits, p_logits, 10 * rel, "logits")
        for key in states:
            _close(states[key], p_states[key], 1e-4 if dtype == "float32" else 2e-2, key)
        if dtype == "float32":
            _, prefix = model(tokens[:, :5], t1_step=False)
            got = select_state(states, torch.tensor([4], device=dev))
            for key in got:
                _close(got[key], prefix[key], 1e-4, key)


def _eager_rounds(monkeypatch):
    from rwkv_lm_ext_tpu_torch.infer import speculative

    monkeypatch.setattr(speculative._Rounds, "_replay",
                        lambda self, name, body, warmup, gen: body())


@pytest.mark.parametrize("version", [6.0, 5.2, 4.0])
def test_speculative_rounds_replay_bit_equal_to_eager(dev, version, monkeypatch):
    """Greedy (self-draft and truncated draft) and sampled speculative
    generation on a bf16 2-layer model as graph replays and as eager rounds:
    the same tokens, the same stats and the same final static state."""
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
    from rwkv_lm_ext_tpu_torch.infer.speculative import SpeculativeEngine, truncated_draft

    model, _ = (_decode_model(dev, 62, dtype="bfloat16") if version == 6.0
                else _family_model(dev, 62, version, dtype="bfloat16"))
    cases = [(truncated_draft(model, 1), None), (model, None),
             (truncated_draft(model, 1),
              SamplingParams(temperature=1.0, top_p=0.9, alpha_presence=0.0, alpha_frequency=0.0,
                             token_stop=()))]

    def run():
        outs = []
        for draft, sp in cases:
            spec = SpeculativeEngine(model, draft, gamma=4)
            out, st = spec.generate([5, 9, 23, 411, 7], max_tokens=17, token_stop=(), sampling=sp,
                                    seed=3, return_stats=True)
            rounds = next(iter(spec._rounds.values()))
            outs.append((out, st, {k: v.clone() for k, v in rounds.t_state.items()},
                         {k: v.clone() for k, v in rounds.d_state.items()}, rounds.graphs))
        return outs

    graph = run()
    assert all(set(g[4]) == {"round", "rollback"} for g in graph)
    _eager_rounds(monkeypatch)
    for (toks, st, ts, ds, _), (e_toks, e_st, e_ts, e_ds, graphs) in zip(graph, run()):
        assert not graphs and toks == e_toks and st == e_st
        assert _states_equal(ts, e_ts) and _states_equal(ds, e_ds)
        assert len(toks) == 17


def test_speculative_greedy_fp32_equals_the_engine(dev):
    """On the kernel route in fp32 the speculative greedy output is the
    engine's penalty-free greedy output, for an unrelated draft and for a
    truncated self-draft."""
    from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
    from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
    from rwkv_lm_ext_tpu_torch.infer.speculative import SpeculativeEngine, truncated_draft

    model, _ = _model(dev, 63)
    other, _ = _model(dev, 64, n_embd=128)
    prompt = [5, 9, 23, 411, 7]
    want = GenerationEngine(model).generate(prompt, max_tokens=24,
                                            sampling=SamplingParams(**GRAPH_GREEDY, token_stop=()))
    for draft in (other, truncated_draft(model, 1)):
        out = SpeculativeEngine(model, draft, gamma=5).generate(prompt, max_tokens=24,
                                                               token_stop=())
        assert out == want
