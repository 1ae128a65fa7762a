"""The port's T=1 decode step (CPU, plain versions) vs the JAX package, and
against the port's own full forward.

Tolerances: the decode op 2e-4 against the Pallas decode kernel in
interpret mode (as tests/test_fused_wkv.py:385-388 holds it against its jnp
composition); the model step 1e-4 * max against JAX's rwkv_decode_step
(fp32, summation order); prefill + decode against one full forward
1e-5 * max (the same arithmetic in another order, as tests/test_model.py:55).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.decode import rwkv_decode_step as jax_rwkv_decode_step
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.models.state import pack_wkv, unpack_wkv
from rwkv_lm_ext_tpu.ops.wkv_decode import _pick_bt_packed, wkv6_decode_step_packed_pallas
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.models.decode import decode_supported, rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.models.state import state_from_jax
from rwkv_lm_ext_tpu_torch.ops import launch_counts
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import wkv6_decode_step, wkv6_decode_step_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import wkv6_fused_output_plain

torch.set_num_threads(1)  # tier-1 runs several pytest workers

EPS = 6.4e-4


def _decode_inputs(rng, B, H, N):
    C = H * N
    mk = lambda *sh: rng.normal(size=sh).astype(np.float32)
    return dict(
        r=mk(B, C), k=mk(B, C), v=mk(B, C),
        w=rng.uniform(-8, 2.5, size=(B, C)).astype(np.float32),
        g=mk(B, C), u=mk(H, N) * 0.5, ln_scale=1 + 0.1 * mk(C), ln_bias=0.1 * mk(C),
        state=mk(B, H, N, N) * 0.3,
    )


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("B,H,N", [(4, 2, 64), (4, 2, 32)])
def test_decode_step_plain_matches_pallas(B, H, N):
    assert _pick_bt_packed(B, H, N) is not None     # reaches pallas_call
    a = _decode_inputs(np.random.default_rng(N), B, H, N)
    want_out, want_s = wkv6_decode_step_packed_pallas(
        *(jnp.asarray(a[k]) for k in ("r", "k", "v", "w", "g", "u", "ln_scale", "ln_bias")),
        pack_wkv(jnp.asarray(a["state"])), EPS, True,
    )
    got_out, got_s = wkv6_decode_step(**_t(a), eps=EPS)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(unpack_wkv(want_s, N)), rtol=2e-4, atol=2e-4)


def test_decode_step_is_k1_at_t1_and_updates_in_place():
    """The same function as K1's plain version at T=1; out_state=state
    writes the new state over the old one."""
    B, H, N = 3, 2, 32
    a = _t(_decode_inputs(np.random.default_rng(0), B, H, N))
    out, s = wkv6_decode_step_plain(**a, eps=EPS)
    heads = (B, 1, H, N)
    k1_out, k1_s = wkv6_fused_output_plain(
        *(a[k].view(heads) for k in ("r", "k", "v", "w")), a["u"], a["g"].view(heads),
        a["ln_scale"], a["ln_bias"], a["state"], eps=EPS,
    )
    np.testing.assert_allclose(out.numpy(), k1_out.view(B, -1).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), k1_s.numpy(), rtol=1e-6, atol=1e-6)
    state = a["state"].clone()
    out2, s2 = wkv6_decode_step(**{**a, "state": state}, eps=EPS, out_state=state)
    assert s2.data_ptr() == state.data_ptr()
    assert torch.equal(out2, out) and torch.equal(state, s)


def _jax_cfg(**kw):
    base = dict(n_layer=2, n_embd=128, vocab_size=1000, head_size=64,
                dtype="float32", param_dtype="float32")
    base.update(kw)
    return JaxModelConfig(**base)


def _jax_params(cfg, seed=0):
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    return params


def _port_model(params, jcfg):
    sd = jax_params_to_state_dict(params, jcfg)
    return load_state_dict_into(RWKV(sniff_model_config(sd, dtype="float32"), device="cpu"), sd)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_rwkv_decode_step_matches_jax():
    """Four streams with a carried state: JAX prefills, both sides take one
    decode step from JAX's state."""
    jcfg = _jax_cfg()
    params = _jax_params(jcfg, seed=1)
    model = _port_model(params, jcfg)
    rng = np.random.default_rng(2)
    prompt = rng.integers(4, 1000, size=(4, 9))
    nxt = rng.integers(4, 1000, size=(4,))
    _, jstate = jax_rwkv_forward(params, jcfg, jnp.asarray(prompt))
    want_logits, want_state = jax_rwkv_decode_step(params, jcfg, jnp.asarray(nxt), jstate)
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             state_from_jax({k: np.asarray(v) for k, v in jstate.items()}, 64).items()}
    with torch.no_grad():
        logits, new_state = rwkv_decode_step(model, torch.from_numpy(nxt), state)
    _close(logits.numpy(), want_logits, 1e-4)
    want_state = state_from_jax({k: np.asarray(v) for k, v in want_state.items()}, 64)
    for key in ("att_shift", "wkv", "ffn_shift"):
        _close(new_state[key].numpy(), want_state[key], 1e-4)


def test_prefill_then_decode_matches_full_forward():
    jcfg = _jax_cfg()
    model = _port_model(_jax_params(jcfg, seed=3), jcfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(4, 1000, size=(2, 40)))
    with torch.no_grad():
        full, full_state = model(tokens)
        logits, state = model(tokens[:, :25])
        steps = [logits[:, -1]]
        for t in range(25, 40):
            lg, state = rwkv_decode_step(model, tokens[:, t], state, out=state)
            steps.append(lg)
    _close(torch.stack(steps[:-1], 1).numpy(), full[:, 24:39].numpy(), 1e-5)
    _close(steps[-1].numpy(), full[:, 39].numpy(), 1e-5)
    for key in state:
        _close(state[key].numpy(), full_state[key].numpy(), 1e-5)


def test_forward_routes_t1_to_the_decode_step():
    """model(tokens (B, 1)) runs the decode step, leaves the given state as
    it was, and agrees with the generic route (t1_step=False)."""
    jcfg = _jax_cfg()
    model = _port_model(_jax_params(jcfg, seed=5), jcfg)
    assert decode_supported(model.cfg)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(4, 1000, size=(3, 8)))
    with torch.no_grad():
        _, state = model(tokens[:, :7])
        before = {k: v.clone() for k, v in state.items()}
        step, step_state = model(tokens[:, 7:])
        generic, generic_state = model(tokens[:, 7:], state, t1_step=False)
        routed, routed_state = model(tokens[:, 7:], state)
    assert all(torch.equal(before[k], state[k]) for k in state)
    assert routed.shape == generic.shape == (3, 1, 1000)
    _close(routed.numpy(), generic.numpy(), 1e-5)
    for key in state:
        _close(routed_state[key].numpy(), generic_state[key].numpy(), 1e-5)
    assert not torch.equal(step, routed)          # the state was used


def test_decode_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    before = launch_counts()
    meta = lambda *s: torch.empty(*s, device="meta")
    r = meta(2, 128)
    with pytest.raises(ValueError):
        wkv6_decode_step(r, r, r, r, r, torch.ones(2, 64), torch.ones(128), torch.zeros(128),
                         meta(2, 2, 64, 64), eps=EPS)
    with pytest.raises(ValueError, match="head size"):
        wkv6_decode_step(*(meta(2, 96),) * 5, torch.ones(2, 48), torch.ones(96), torch.zeros(96),
                         meta(2, 2, 48, 48), eps=EPS)
    assert launch_counts() == before
