"""Head size 128 through the port (CPU, the kernels' plain versions) against
the JAX package, whose own kernels leave N = 128 to XLA
(rwkv_lm_ext_tpu/ops/wkv_pallas.py:591).

The model: the shared RWKV-6 fixture (tests/torch_stack_setup.py) at 2
layers, C=256, H=2, N=128, fp32. Its forward (logits and state) and its T=1
decode step against JAX's within 1e-4 of their largest value (the JAX route
sums in another order); one ``sft --train-type lora`` step of both CLIs
(``check_sft_against_jax``: loss at rtol 1e-5, gradient norm at rtol 1e-4,
the adapter after the step within 1e-5 of its largest value or half the lr);
the fused decode route (B.10-B.12 around B.9) against the unfused step within
1e-5; and the head sizes each wrapper takes or refuses by name (B.13 is built
for N of 16, 32 and 64).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu_torch.models.decode import decode_supported, rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.state import state_from_jax
from rwkv_lm_ext_tpu_torch.ops.wkv_decode import HEAD_SIZES, wkv6_decode_step_transposed
from rwkv_lm_ext_tpu_torch.ops.wkv_fused import check_head_size, k1_body, wkv_bwd_body
from torch_stack_setup import check_sft_against_jax, jax_params, sft_data, torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers

N = 128
TOKENS = np.random.default_rng(6).integers(3, 1000, size=(2, 9))


def assert_close(got, want, what, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


@pytest.fixture(scope="module")
def case():
    params, jcfg = jax_params(seed=2, n_embd=256, head_size=N)
    logits, state = jax_rwkv_forward(params, jcfg, jnp.asarray(TOKENS))
    step, state1 = jax_rwkv_forward(params, jcfg, jnp.asarray(TOKENS[:, :1]), state)
    ref = dict(logits=np.asarray(logits), state=state_from_jax(state, N), step=np.asarray(step),
               state1=state_from_jax(state1, N))
    return torch_model(params, jcfg), ref


def test_n128_forward_and_decode_step_match_jax(case):
    model, ref = case
    assert model.cfg.head_size == N and decode_supported(model.cfg)
    with torch.no_grad():
        logits, state = model(torch.from_numpy(TOKENS))
        assert_close(logits, ref["logits"], "logits")
        for key in state:
            assert_close(state[key], ref["state"][key], key)
        step, state1 = rwkv_decode_step(model, torch.from_numpy(TOKENS[:, 0]), state)
    assert_close(step, ref["step"][:, 0], "T=1 logits")
    for key in state1:
        assert_close(state1[key], ref["state1"][key], f"T=1 {key}")


def test_n128_fused_decode_route_equals_the_unfused_step(case):
    model, _ = case
    with torch.no_grad():
        _, state = model(torch.from_numpy(TOKENS))
        tok = torch.from_numpy(TOKENS[:, -1])
        a, sa = rwkv_decode_step(model, tok, {k: v.clone() for k, v in state.items()})
        b, sb = rwkv_decode_step(model, tok, {k: v.clone() for k, v in state.items()},
                                 fused_prep=True)
    assert_close(b, a, "fused logits", rel=1e-5)
    for key in sa:
        assert_close(sb[key], sa[key], f"fused {key}", rel=1e-5)


def test_n128_sft_lora_step_matches_the_jax_command(tmp_path):
    sft_data(tmp_path)
    check_sft_against_jax(str(tmp_path / "sft.jsonl"), tmp_path, ["--train-type", "lora"],
                          steps=1, params=jax_params(seed=2, n_embd=256, head_size=N))


def test_head_sizes_taken_and_refused_by_name():
    check_head_size(N, "K1")
    assert N in HEAD_SIZES
    # no chunked body at N = 128: both dtypes run the sequential ones
    assert k1_body(torch.bfloat16, N) == wkv_bwd_body(torch.bfloat16, N) == "sequential"
    with pytest.raises(ValueError, match="head size 96 not supported by K1"):
        check_head_size(96, "K1")
    B, H = 1, 2
    vec = torch.zeros(B, H * N)
    with pytest.raises(ValueError, match="head size 128 not supported by B.13"):
        wkv6_decode_step_transposed(vec, vec, vec, vec, vec, torch.zeros(H, N),
                                    torch.ones(H * N), torch.zeros(H * N),
                                    torch.zeros(B, H, N, N), eps=1e-5)
