"""Plain versions of the port's kernels (CPU) vs the JAX package's Pallas
kernels run in interpret mode, at shapes that reach pallas_call, on the same
numpy-seeded fp32 inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.ops.ddlerp_pallas import tmix_prologue as jax_tmix_prologue
from rwkv_lm_ext_tpu.ops.ln_pallas import layer_norm_pallas
from rwkv_lm_ext_tpu.ops.wkv_pallas import wkv6_fused_output as jax_wkv6_fused_output
from rwkv_lm_ext_tpu.ops.wkv_reference import wkv_reference as jax_wkv_reference
from rwkv_lm_ext_tpu_torch.ops import launch_counts
from rwkv_lm_ext_tpu_torch.ops.ddlerp import tmix_prologue
from rwkv_lm_ext_tpu_torch.ops.ln import layer_norm
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import wkv6_fused_output

torch.set_num_threads(1)  # tier-1 runs several pytest workers


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_layer_norm_plain_matches_pallas():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(512, 128)) * 3 + 1).astype(np.float32)
    sc = rng.normal(1.0, 0.2, size=128).astype(np.float32)
    bi = rng.normal(0.0, 0.2, size=128).astype(np.float32)
    want = layer_norm_pallas(*_j(x, sc, bi), 1e-5, interpret=True)
    got = layer_norm(*_t(x, sc, bi), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_tmix_prologue_plain_matches_pallas():
    rng = np.random.default_rng(1)
    B, T, C, D = 2, 128, 128, 32
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    shift = rng.normal(size=(B, C)).astype(np.float32)     # non-zero shift
    sc = rng.normal(1.0, 0.2, size=C).astype(np.float32)
    bi = rng.normal(0.0, 0.2, size=C).astype(np.float32)
    maa = rng.uniform(0, 1, size=(6, C)).astype(np.float32)
    w1 = (rng.normal(size=(C, 5 * D)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(5, D, C)) * 0.1).astype(np.float32)
    want = jax_tmix_prologue(*_j(x, shift, sc, bi, maa, w1, w2), eps=1e-5, interpret=True)
    got = tmix_prologue(*_t(x, shift, sc, bi, maa, w1, w2), eps=1e-5)
    assert len(got) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T", [37, 64])
def test_wkv6_fused_plain_matches_pallas(T):
    rng = np.random.default_rng(T)
    B, H, N = 2, 2, 64      # P = 128 // N = 2 heads per lane block: native Pallas geometry
    mk = lambda: rng.normal(size=(B, T, H, N)).astype(np.float32)
    r, k, v, g = mk(), mk(), mk(), mk()
    w = rng.uniform(-8, 2.5, size=(B, T, H, N)).astype(np.float32)   # decays ~1 .. ~5e-6
    u = (rng.normal(size=(H, N)) * 0.5).astype(np.float32)
    sc = rng.normal(1.0, 0.1, size=H * N).astype(np.float32)
    bi = rng.normal(0.0, 0.1, size=H * N).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, N)) * 0.1).astype(np.float32)
    eps = 6.4e-4
    want_out, want_s = jax_wkv6_fused_output(
        *_j(r, k, v, w, u, g, sc, bi, s0), eps=eps, interpret=True
    )
    _, golden_s = jax_wkv_reference(*_j(r, k, v, w, u, s0))
    got_out, got_s = wkv6_fused_output(*_t(r, k, v, w, u, g, sc, bi, s0), eps=eps)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=3e-4, atol=3e-4)
    # the state against JAX's sequential golden: same recurrence, fp32 order
    np.testing.assert_allclose(got_s.numpy(), np.asarray(golden_s), rtol=0, atol=2e-5)
    # against the Pallas kernel, whose chunked factoring is itself 5.6e-5
    # off the golden at T=64 (|S| <= 11): 1e-5 of the state's magnitude
    want_s = np.asarray(want_s)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-5 * np.abs(want_s).max())


def test_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """A tensor that is not on the CPU goes to the kernel path, never to the
    plain version: on a device that is not CUDA the wrapper raises. No
    launch is counted."""
    before = launch_counts()
    x = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError):
        layer_norm(x, torch.ones(16), torch.zeros(16))
    with pytest.raises(ValueError):
        tmix_prologue(x, torch.empty(2, 16, device="meta"), torch.ones(16),
                      torch.zeros(16), torch.ones(6, 16), torch.ones(16, 40),
                      torch.ones(5, 8, 16))
    r = torch.empty(2, 8, 2, 64, device="meta")
    with pytest.raises(ValueError):
        wkv6_fused_output(r, r, r, r, torch.ones(2, 64), r, torch.ones(128),
                          torch.zeros(128), eps=1e-3)
    with pytest.raises(ValueError, match="head size"):
        wkv6_fused_output(*(torch.empty(1, 4, 2, 48, device="meta"),) * 4,
                          torch.ones(2, 48), torch.empty(1, 4, 2, 48, device="meta"),
                          torch.ones(96), torch.zeros(96), eps=1e-3)
    assert launch_counts() == before
