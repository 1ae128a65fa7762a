"""The port's collect forward (models/collect.py) and the collecting WKV
(ops/wkv_reference.wkv_collect, ops/wkv_collect.wkv6_collect's plain
version) against the JAX package on the CPU, fp32.

Sizes of tests/test_collect.py: 2 layers, C=64, head size 16, vocab 160; the
same weights on both sides (a JAX init whose zero-initialised projections get
seeded values, carried into the port by checkpoint.convert). Each JAX
reference is computed once per module. Tolerances are JAX's own test's:
rtol = atol = 2e-5 (both sides sum in fp32, in other orders; the RWKV-5 route
differs by GroupNorm(y / 8, 1e-5) against GroupNorm(y, 64e-5), equal up to
rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.collect import rwkv_forward_collect as jax_forward_collect
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.models.state import unpack_wkv as jax_unpack_wkv
from rwkv_lm_ext_tpu.ops.wkv_reference import wkv_collect as jax_wkv_collect
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.models.collect import (
    collect_supported,
    rwkv_forward_collect,
    select_state,
)
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.models.state import state_from_jax
from rwkv_lm_ext_tpu_torch.ops.wkv_collect import wkv6_collect, wkv6_collect_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import wkv6_fused_output_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_reference import wkv_collect
from torch_stack_setup import torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers

TOL = dict(rtol=2e-5, atol=2e-5)
VOCAB = 160
KEYS = ("att_shift", "wkv", "ffn_shift")


def jax_model(version: float, seed: int = 0):
    """(params, cfg) of a 2-layer JAX model whose zero-initialised
    projections get seeded values (else every block is a no-op)."""
    cfg = JaxModelConfig(n_layer=2, n_embd=64, vocab_size=VOCAB, head_size=16, dtype="float32",
                         param_dtype="float32", version=version)
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    return params, cfg


def _wkv_inputs(seed, B=2, T=7, H=2, N=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, N)).astype(np.float32) for _ in range(3))
    w = rng.uniform(-6.0, 1.0, size=(B, T, H, N)).astype(np.float32)
    u = (0.5 * rng.normal(size=(H, N))).astype(np.float32)
    s0 = (0.3 * rng.normal(size=(B, H, N, N))).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("nonzero_state", [False, True])
def test_wkv_collect_matches_jax(nonzero_state):
    r, k, v, w, u, s0 = _wkv_inputs(1)
    s0 = s0 if nonzero_state else None
    jy, js = jax_wkv_collect(*map(jnp.asarray, (r, k, v, w, u)),
                             None if s0 is None else jnp.asarray(s0))
    y, states = wkv_collect(*map(torch.from_numpy, (r, k, v, w, u)),
                            None if s0 is None else torch.from_numpy(s0))
    assert states.shape == (7, 2, 2, 16, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(js), **TOL)


def test_collecting_wkv_is_k1_with_every_state():
    """B.15's plain version: K1's plain output, its last state K1's final
    state, into a strided slice of a stacked buffer as well."""
    r, k, v, w, u, s0 = map(torch.from_numpy, _wkv_inputs(2))
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.normal(size=r.shape).astype(np.float32))
    sc = torch.from_numpy((1 + 0.1 * rng.normal(size=32)).astype(np.float32))
    bi = torch.from_numpy((0.1 * rng.normal(size=32)).astype(np.float32))
    args = (r, k, v, w, u, g, sc, bi, s0)
    want, sT = wkv6_fused_output_plain(*args, eps=6.4e-4)
    out, states = wkv6_collect(*args, eps=6.4e-4)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(states[-1], sT, rtol=0, atol=0)
    stack = torch.zeros(7, 3, 2, 2, 16, 16)
    out2, view = wkv6_collect(*args, eps=6.4e-4, out_states=stack[:, 1])
    assert view.data_ptr() == stack[:, 1].data_ptr() and torch.equal(stack[:, 1], states)
    assert stack[:, 0].abs().sum() == 0 and torch.equal(out2, out)
    shared = wkv6_collect_plain(*args[:8], s0[0], eps=6.4e-4)[1]     # (H, N, N) for every row
    torch.testing.assert_close(shared, wkv_collect(r, k, v, w, u, s0[0].expand(2, -1, -1, -1))[1],
                               rtol=0, atol=0)


@pytest.fixture(scope="module", params=[6.0, 5.2], ids=["v6", "v5.2"])
def family(request):
    """The JAX model of one version, its port twin, the tokens, and JAX's
    collect forward on them (logits, logical states)."""
    params, cfg = jax_model(request.param)
    toks = np.random.default_rng(4).integers(0, VOCAB, size=(1, 7))
    logits, states = jax_forward_collect(params, cfg, jnp.asarray(toks))
    states = {k: np.asarray(v) for k, v in states.items()}
    states["wkv"] = np.asarray(jax_unpack_wkv(jnp.asarray(states["wkv"]), cfg.head_size))
    return params, cfg, torch_model(params, cfg), toks, np.asarray(logits), states


def test_forward_collect_matches_jax(family):
    _, _, model, toks, jlogits, jstates = family
    with torch.inference_mode():
        logits, states = rwkv_forward_collect(model, torch.from_numpy(toks))
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    for j in (0, 3, 6):
        for key in KEYS:
            np.testing.assert_allclose(states[key][j].numpy(), jstates[key][j], **TOL,
                                       err_msg=f"{key} at j={j}")


def test_select_state_is_the_prefix_forward(family):
    """select_state(states, j) (j a tensor) is the port's own forward over
    tokens[:, :j+1], from a zero state and from a state after a warm-up;
    the collect forward's logits are the forward's."""
    params, cfg, model, toks, _, _ = family
    tok = torch.from_numpy(toks)
    warm = torch.from_numpy(np.random.default_rng(5).integers(0, VOCAB, size=(1, 5)))
    with torch.inference_mode():
        _, st0 = model(warm)
        for start in (None, st0):
            logits, states = rwkv_forward_collect(model, tok, start)
            full, _ = model(tok, start, t1_step=False)
            torch.testing.assert_close(logits, full, **TOL)
            for j in (0, 3, 6):
                _, want = model(tok[:, :j + 1], start, t1_step=False)
                got = select_state(states, torch.tensor([j]))
                for key in KEYS:
                    torch.testing.assert_close(got[key], want[key], **TOL)
        # from the warm state against JAX's full forward over both pieces
        _, jst = jax_rwkv_forward(params, cfg, jnp.asarray(np.concatenate([warm, toks], 1)),
                                  wkv_backend="reference")
        got = select_state(rwkv_forward_collect(model, tok, st0)[1], torch.tensor(6))
        for key, value in state_from_jax({k: np.asarray(v) for k, v in jst.items()},
                                         cfg.head_size).items():
            np.testing.assert_allclose(got[key].numpy(), value, **TOL, err_msg=key)


def test_collect_supported_and_refusals():
    base = dict(n_layer=1, n_embd=64, vocab_size=VOCAB, head_size=16)
    assert collect_supported(ModelConfig(**base)) and collect_supported(
        ModelConfig(**base, version=5.0))
    for cfg in (ModelConfig(**base, version=4.0), ModelConfig(**base, pre_ffn=1),
                ModelConfig(**base, head_qk=8), ModelConfig(**base, dropout=0.1),
                ModelConfig(**base, tiny_att_dim=16, tiny_att_layer=0)):
        assert not collect_supported(cfg), cfg
    cfg = ModelConfig(**base, version=4.0, dtype="float32")
    v4 = load_state_dict_into(RWKV(cfg, device="cpu"),
                              init_rwkv_params(cfg, generator=torch.Generator().manual_seed(0),
                                               device="cpu"))
    with pytest.raises(ValueError, match="collect forward"):
        rwkv_forward_collect(v4, torch.zeros(1, 2, dtype=torch.int64))
