"""QLoRA and the weight codecs (CPU, the kernels' plain versions) against
the JAX package on the same numpy-seeded weights and batches.

Tolerances:
- nf4 / fp4: packed codes, scales and dequantized values bit-equal (the
  same fp32 operations); so are the four modes' quantize_model /
  dequantize_model against quantize_tree / dequantize_tree.
- the 4-bit forwards: logits within 1e-4 of max|JAX logits| (the same
  weights, summation order apart).
- QLoRA over int8, nf4 and fp4 through the ``sft`` command: the harness of
  tests/torch_stack_setup.py (SFT_DOC), loss at rtol 1e-5, grad_norm at
  rtol 1e-4, the adapter after three steps within 1e-5 of its largest value
  or half the lr.
- int8c: one projection's straight-through dx equals the test-built
  reference's within 1e-6 of its largest value (the same int8 codes, the
  same fp32 product). Through a model, int8c rounds every activation to
  int8, and a rounding that lands on the other side of a half (the two
  packages' activations differ in the last bits, by summation order) moves
  that row's product by about 1/127 of its absmax. On this file's int8c
  model the JAX package's own straight-through gradients move by up to
  1.06e-2 of their largest value when the embedding is scaled by 1 + 3e-6
  (by 1.9e-6 under 1 + 1e-6: the roundings flip in steps), and the port's
  sit 8.1e-3 from them. So the port's int8c loss is held to JAX's int8c
  forward at rtol 1e-4, its gradients to the straight-through reference
  within 1e-2 of each tensor's largest value, and the int8 mode (no
  activation rounding) on the same model within 1e-4 as the control.
"""
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.adapters import LoraConfig as JaxLoraConfig
from rwkv_lm_ext_tpu.adapters import apply_lora_unfused
from rwkv_lm_ext_tpu.adapters import init_lora_params as jax_init_lora_params
from rwkv_lm_ext_tpu.adapters.quant import dequantize_nf4, dequantize_tree
from rwkv_lm_ext_tpu.adapters.quant import int8_matmul as jax_int8_matmul
from rwkv_lm_ext_tpu.adapters.quant import quantize_int8 as jax_quantize_int8
from rwkv_lm_ext_tpu.adapters.quant import quantize_nf4, quantize_tree
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.train.loop import sft_loss_fn as jax_sft_loss_fn
from rwkv_lm_ext_tpu_torch.adapters.lora import LoraConfig, apply_lora
from rwkv_lm_ext_tpu_torch.adapters.quant import (
    CODE4,
    MODES,
    QuantLinear,
    dequantize_4bit,
    dequantize_int8,
    dequantize_model,
    quantize_4bit,
    quantize_int8,
    quantize_model,
)
from rwkv_lm_ext_tpu_torch.checkpoint.convert import lora_tree_from_jax
from rwkv_lm_ext_tpu_torch.models.rwkv import Linear
from rwkv_lm_ext_tpu_torch.train.loop import sft_loss_fn
from torch_stack_setup import (
    _params,
    _reference_wkv,
    check_sft_against_jax,
    jquant,
    jwkv,
    sft_data,
    ste_int8_mm,
    torch_model,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

TARGETS = [("att", n) for n in ("receptance", "key", "value", "gate", "output")] + [
    ("ffn", n) for n in ("key", "value", "receptance")]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("fmt", ["nf4", "fp4"])
@pytest.mark.parametrize("shape", [(96, 40), (50, 30), (128, 448)])
def test_4bit_codes_and_scales_are_the_jax_bits(fmt, shape):
    """quantize_4bit of the port's (out, in) weight holds JAX quantize_nf4's
    packed bytes and scales of the (in, out) leaf (50 x 30 pads its last
    block), a zero block included; the dequantized values are bit-equal."""
    w = (np.random.default_rng(sum(shape)).normal(size=shape) * 0.1).astype(np.float32)
    w[:2] = 0.0                         # a block of zeros (absmax floored at 1e-12)
    w[3, :7] = [0.5, -0.5, 0.25, 1.0, -1.0, 0.0, 1e-9]
    want = quantize_nf4(jnp.asarray(w), fmt=fmt)
    packed, scale, pad = quantize_4bit(torch.from_numpy(w.T.copy()), fmt)
    assert packed.dtype == torch.uint8 and pad == want.pad == (-w.size) % 64
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want.scale))
    got = dequantize_4bit(packed, scale, torch.from_numpy(CODE4[fmt]), (shape[1], shape[0]), pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(dequantize_nf4(want)).T)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_and_dequantize_model_are_the_jax_trees(mode):
    """quantize_model(include_head) against quantize_tree leaf by leaf, then
    dequantize_model against dequantize_tree: bit-equal weights, dense
    Linear modules again."""
    params, cfg = _params(1)
    model = torch_model(params, cfg)
    # eager, as the JAX CLI quantizes; jit would fold int8's division by the
    # constant 127 into a multiply (the 4-bit codecs divide by a tensor,
    # which jit keeps, and run much faster jitted)
    quantize = functools.partial(quantize_tree, mode=mode, include_head=True)
    qtree = quantize(params) if mode in ("int8", "int8c") else jax.jit(quantize)(params)
    quantize_model(model, mode, include_head=True)
    leaves = [(getattr(getattr(model.blocks[i], part), name), qtree["blocks"][i][part][name])
              for i in range(cfg.n_layer) for part, name in TARGETS]
    leaves.append((model.head, qtree["head"]))
    for got, want in leaves:
        assert isinstance(got, QuantLinear) and got.mode == mode == want.qformat
        if mode in ("int8", "int8c"):
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q).T)
            np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale).T)
        else:
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
            np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    dequantize_model(model)
    want = jax_params_to_state_dict(jax.jit(dequantize_tree)(qtree), cfg)
    assert not any(isinstance(m, QuantLinear) for m in model.modules())
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key], np.float32), err_msg=key)
    assert type(model.blocks[1].ffn.value) is Linear


@pytest.mark.parametrize("fmt", ["nf4", "fp4"])
def test_4bit_forward_matches_jax(fmt):
    params, cfg = _params(2)
    model = quantize_model(torch_model(params, cfg), fmt)
    tokens = np.random.default_rng(4).integers(4, 1000, size=(2, 24))
    want, _ = jax.jit(lambda p, t: jax_rwkv_forward(quantize_tree(p, fmt), cfg, t))(
        params, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens))
    assert _rel(got.numpy(), want) <= 1e-4


QLORA_CASES = [
    ["--quant", "int8"],
    ["--quant", "nf4"],
    ["--quant", "fp4"],
    ["--quant", "int8", "--lora-apply", "merge"],
    ["--quant", "nf4", "--lora-apply", "merge"],
]


@pytest.mark.parametrize("extra", QLORA_CASES, ids=[" ".join(e) for e in QLORA_CASES])
def test_qlora_matches_the_jax_command(tmp_path, extra):
    """sft --train-type lora over a quantized base: the pipelines, then
    three steps of each command's step function (SFT_DOC)."""
    check_sft_against_jax(sft_data(tmp_path), tmp_path, ["--train-type", "lora", *extra])


def test_int8c_projection_backward_is_straight_through():
    """One int8c projection under grad: the forward is int8_matmul's (rtol
    1e-6 against the JAX package's), dx = g @ dequantize(q, scale) equals
    the test-built straight-through reference's, and the weight is frozen."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 32)) * 0.1).astype(np.float32)          # JAX (in, out)
    c = rng.normal(size=(2, 9, 32)).astype(np.float32)
    leaf = jax_quantize_int8(jnp.asarray(w), compute=True)
    mm = ste_int8_mm()
    y_want, dx_want = jax.value_and_grad(
        lambda x_: jnp.sum(mm(x_, leaf.q, leaf.scale, jnp.dtype(jnp.float32)) * c))(jnp.asarray(x))
    q, scale = quantize_int8(torch.from_numpy(w.T.copy()))
    lin = QuantLinear(q, scale, "int8c")
    xt = torch.from_numpy(x).requires_grad_(True)
    y = lin(xt)
    y_plain = jax_int8_matmul(jnp.asarray(x), leaf, jnp.float32)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_plain), rtol=1e-6, atol=0)
    (y * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(float((y.detach() * torch.from_numpy(c)).sum()), float(y_want),
                               rtol=1e-5)
    assert _rel(xt.grad.numpy(), dx_want) <= 1e-6
    assert not lin.q.requires_grad and not lin.scale.requires_grad


def test_jax_int8c_gradient_has_one_nonzero_entry_a_row():
    """ROADMAP C.18, pinned: the JAX package's own int8c VJP (the exact VJP
    of the dynamic quantization, through which round passes nothing) gives
    dx one nonzero entry a row (each row's absmax); the port's dx is the
    dx of the dequantized product, within 1e-5 of its largest value."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    c = rng.normal(size=(4, 32)).astype(np.float32)
    leaf = jax_quantize_int8(jnp.asarray(w), compute=True)
    jdx = np.asarray(jax.grad(
        lambda x_: jnp.sum(jax_int8_matmul(x_, leaf, jnp.float32) * c))(jnp.asarray(x)))
    assert ((jdx != 0).sum(-1) == 1).all(), (jdx != 0).sum(-1)
    q, scale = quantize_int8(torch.from_numpy(w.T.copy()))
    xt = torch.from_numpy(x).requires_grad_(True)
    (QuantLinear(q, scale, "int8c")(xt) * torch.from_numpy(c)).sum().backward()
    dense = c @ dequantize_int8(q, scale).numpy()
    assert (xt.grad.numpy() != 0).sum(-1).min() == 64
    assert _rel(xt.grad.numpy(), dense) <= 1e-5


def _qlora_grads(mode, ste: bool):
    """Loss and LoRA gradients of the port and of the JAX package (its
    int8c VJP replaced by the straight-through reference when `ste`) over a
    `mode` base, one batch, the same adapter (B seeded)."""
    params, cfg = _params(3)
    jlc = JaxLoraConfig(r=4, alpha=16.0)
    rng = np.random.default_rng(1)
    adapter = {k: {"A": ab["A"], "B": jnp.asarray(rng.normal(size=ab["B"].shape) * 0.05,
                                                  jnp.float32)}
               for k, ab in jax_init_lora_params(jax.random.PRNGKey(1), params, jlc).items()}
    ids = np.random.default_rng(2).integers(4, 1000, size=(2, 24)).astype(np.int32)
    labels = np.full_like(ids, -100)
    labels[:, 5:-1] = ids[:, 6:]
    batch = {"input_ids": ids, "labels": labels}
    frozen = quantize_tree(params, mode)
    with mock.patch.object(jwkv, "_resolve_backend", _reference_wkv), \
            mock.patch.object(jquant, "_int8_mm", ste_int8_mm() if ste else jquant._int8_mm):
        want_loss, want_g = jax.jit(jax.value_and_grad(lambda a: jax_sft_loss_fn(
            apply_lora_unfused(frozen, a, jlc), cfg, {k: jnp.asarray(v) for k, v in batch.items()},
            remat=False)))(adapter)
    model = quantize_model(torch_model(params, cfg), mode)
    apply_lora(model, LoraConfig(r=4, alpha=16.0), lora_tree_from_jax(adapter))
    loss = sft_loss_fn(model, {k: torch.from_numpy(v).long() for k, v in batch.items()}, remat=True)
    loss.backward()
    rel = {f"{n}.{ab}": _rel(getattr(m, f"lora_{ab}").grad.numpy(), want_g[n][ab])
           for n, m in model.named_modules() if hasattr(m, "lora_A") for ab in "AB"}
    return loss.item(), float(want_loss), rel


def test_int8c_qlora_loss_and_straight_through_gradients():
    """int8c QLoRA through a 2-layer model (remat on): the loss against JAX's
    int8c forward, the LoRA gradients against the straight-through
    reference, and the int8 mode's gradients as the control (module
    docstring)."""
    loss, want_loss, _ = _qlora_grads("int8c", ste=False)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    _, _, rel = _qlora_grads("int8c", ste=True)
    assert len(rel) == 32 and max(rel.values()) <= 1e-2, max(rel.items(), key=lambda kv: kv[1])
    _, _, rel8 = _qlora_grads("int8", ste=False)
    assert max(rel8.values()) <= 1e-4, max(rel8.items(), key=lambda kv: kv[1])


def test_int8c_qlora_command_matches_the_jax_pipeline(tmp_path):
    """sft --quant int8c: the pipelines batch for batch, and one step of
    each command's step function (the JAX one with the straight-through
    VJP) at the int8c tolerances of the module docstring: loss rtol 1e-4,
    grad_norm rtol 1e-2."""
    check_sft_against_jax(sft_data(tmp_path), tmp_path, ["--train-type", "lora", "--quant", "int8c"],
                          ste=True, steps=1, rtol=(1e-4, 1e-2), compare_params=False)
