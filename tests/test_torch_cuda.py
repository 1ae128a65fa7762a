"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the edge shapes the main path does not reach: ragged T and C, T=1, both
head sizes, fp32 as well as bf16, and no initial state. The plain version runs
in fp32 on the same (dtype-rounded) inputs.

These tests need an NVIDIA GPU and skip elsewhere. The GPU machine has no
JAX, so run them there without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerances: out <= REL[dtype] * max|plain| (fp32: summation order only;
bf16: one rounding of each output), the WKV state <= 1e-4 * max|plain|
(fp32 in both).
"""
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.ops import launch_counts
from rwkv_lm_ext_tpu_torch.ops.ddlerp import tmix_prologue, tmix_prologue_plain
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm, layer_norm_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import wkv6_fused_output, wkv6_fused_output_plain

pytestmark = pytest.mark.cuda

REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, dtype, rng, *shape, scale=1.0, loc=0.0):
    a = rng.normal(loc, scale, size=shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


def _close(got, want, rel):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), (err, want.abs().max().item())


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
    assert {k: after[k] - before[k] for k in after} == {
        "layer_norm": 4, "tmix_prologue": 2, "wkv6_fused_output": 2}
    assert launch_counts() == after        # the plain route launches nothing
    _close(got, want, 1e-4)
    for key in want_state:
        _close(got_state[key], want_state[key], 1e-4)
