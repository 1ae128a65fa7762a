"""The port's int8 / int8c quantization (CPU, plain versions) vs the JAX
package on the same numpy-seeded inputs and the same weights.

Tolerances: the row quantizer and the weight codec are bit-equal; the int8
product and its rescale equal up to rtol 1e-6 (the same fp32 operations);
a 2-layer int8c forward within 1e-3 * max|logits| (the int8 product is
exact, the rest of the forward differs in summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.adapters.quant import int8_matmul as jax_int8_matmul
from rwkv_lm_ext_tpu.adapters.quant import quantize_int8 as jax_quantize_int8
from rwkv_lm_ext_tpu.adapters.quant import quantize_tree
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.checkpoint.pth import save_torch_pth
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.heads import embed_sequences as jax_embed_sequences
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.ops.quant_pallas import quantize_rows as jax_quantize_rows
from rwkv_lm_ext_tpu.ops.quant_pallas import quantize_rows_xla
from rwkv_lm_ext_tpu_torch.adapters.quant import (
    QuantLinear,
    dequantize_int8,
    int8_matmul,
    quantize_int8,
    quantize_model,
)
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_rwkv_checkpoint, load_state_dict_into
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.config import EMB_ID
from rwkv_lm_ext_tpu_torch.models.heads import embed_sequences
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.ops import launch_counts
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows, quantize_rows_plain

torch.set_num_threads(1)  # tier-1 runs several pytest workers

TARGETS = [("att", n) for n in ("receptance", "key", "value", "gate", "output")] + [
    ("ffn", n) for n in ("key", "value", "receptance")]


def _jax_cfg(**kw):
    base = dict(n_layer=2, n_embd=128, vocab_size=1000, head_size=64,
                dtype="float32", param_dtype="float32")
    base.update(kw)
    return JaxModelConfig(**base)


def _jax_params(cfg, seed=0):
    """JAX init with the zero-initialised projections filled."""
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    return params


def _port_model(params, jcfg):
    sd = jax_params_to_state_dict(params, jcfg)
    return load_state_dict_into(RWKV(sniff_model_config(sd, dtype="float32"), device="cpu"), sd), sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 128), (4, 96, 256), (8, 7, 128)])
def test_quantize_rows_plain_is_bit_equal_to_pallas(shape, dtype):
    """Against the Pallas kernel (interpret mode) and the jitted XLA
    composition: both scale by ax * fl(1/127), which XLA folds the
    division by the constant 127 into."""
    rng = np.random.default_rng(sum(shape))
    x32 = (rng.normal(size=shape) * rng.uniform(0.01, 30.0, size=shape[:-1] + (1,))).astype(np.float32)
    xj = jnp.asarray(x32).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    q, s = quantize_rows(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == shape[:-1] + (1,)
    for want_q, want_s in (jax_quantize_rows(xj, interpret=True), jax.jit(quantize_rows_xla)(xj)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


def test_quantize_rows_zero_rows_and_half_way_ties():
    """A zero row gives q = 0 and s = 1e-12; a row with absmax 127 has
    s = 127 * fl(1/127) and values k + 0.5 round half to even, as jnp.round."""
    x = np.zeros((4, 16), np.float32)
    x[1] = np.linspace(-127, 127, 16)
    x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[3] = 1e-14
    q, s = quantize_rows_plain(torch.from_numpy(x))
    want_q, want_s = jax.jit(quantize_rows_xla)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert q[0].abs().sum() == 0 and s[0, 0] == np.float32(1e-12)


@pytest.mark.parametrize("mode", ["int8", "int8c"])
def test_quantize_model_is_bit_equal_to_quantize_tree(mode):
    jcfg = _jax_cfg()
    params = _jax_params(jcfg, seed=1)
    model, _ = _port_model(params, jcfg)
    qtree = quantize_tree(params, mode, include_head=True)
    quantize_model(model, mode, include_head=True)
    pairs = [(getattr(model.blocks[i], part).__getattr__(name), qtree["blocks"][i][part][name])
             for i in range(jcfg.n_layer) for part, name in TARGETS]
    pairs.append((model.head, qtree["head"]))
    for got, want in pairs:
        assert isinstance(got, QuantLinear) and got.mode == mode == want.qformat
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q).T)
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale).T)


def test_int8_matmul_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 96)).astype(np.float32)
    w = (rng.normal(size=(96, 40)) * 0.1).astype(np.float32)       # JAX (in, out)
    leaf = jax_quantize_int8(jnp.asarray(w), compute=True)
    want = jax_int8_matmul(jnp.asarray(x), leaf, jnp.float32)
    q, scale = quantize_int8(torch.from_numpy(w.T.copy()))
    got = int8_matmul(torch.from_numpy(x), q, scale, torch.float32)
    assert got.shape == (2, 9, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    # int8 (dequantize on use) equals the dense product with the codec's weight
    lin = QuantLinear(q, scale, "int8")
    np.testing.assert_allclose(
        lin(torch.from_numpy(x)).numpy(), x @ dequantize_int8(q, scale).numpy().T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8c", "int8"])
def test_quantized_forward_matches_jax(mode):
    jcfg = _jax_cfg()
    params = _jax_params(jcfg, seed=3)
    model, _ = _port_model(params, jcfg)
    quantize_model(model, mode)
    tokens = np.random.default_rng(4).integers(4, 1000, size=(2, 24))
    want, _ = jax_rwkv_forward(quantize_tree(params, mode), jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3 * np.abs(want).max())


def test_int8c_embedding_drift_against_unquantized():
    """The JAX package's drift acceptance (tests/test_quant_kg.py:89-117):
    int8c embeddings (head quantized too) within cosine 1e-3 of the
    unquantized ones, on that test's geometry and weights recipe."""
    jcfg = _jax_cfg(n_embd=64, vocab_size=100, head_size=16)
    params = jax_init_rwkv_params(jax.random.PRNGKey(0), jcfg)
    for i, b in enumerate(params["blocks"]):
        b["att"]["output"] = 0.05 * jax.random.normal(jax.random.PRNGKey(5 + i), b["att"]["output"].shape)
        b["ffn"]["value"] = 0.05 * jax.random.normal(jax.random.PRNGKey(15 + i), b["ffn"]["value"].shape)
    tokens = np.random.RandomState(1).randint(2, 100, (3, 24))
    for i, ln in enumerate([23, 16, 10]):
        tokens[i, ln] = EMB_ID
        tokens[i, ln + 1:] = 0
    model, _ = _port_model(params, jcfg)
    with torch.no_grad():
        e_f = embed_sequences(model, torch.from_numpy(tokens)).double().numpy()
        quantize_model(model, "int8c", include_head=True)
        e_q = embed_sequences(model, torch.from_numpy(tokens)).double().numpy()
    cos = (e_f * e_q).sum(-1) / (np.linalg.norm(e_f, axis=-1) * np.linalg.norm(e_q, axis=-1))
    assert float(1.0 - cos.min()) <= 1e-3, cos
    # the port's unquantized embeddings are JAX's
    want = np.asarray(jax_embed_sequences(params, jcfg, jnp.asarray(tokens)))
    np.testing.assert_allclose(e_f, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_checkpoint_quantizes_the_fp32_values_before_the_cast(tmp_path):
    """load_rwkv_checkpoint(quant=...) quantizes the checkpoint's fp32
    values, not their bf16 rounding, and leaves the rest in cfg.dtype."""
    jcfg = _jax_cfg()
    params = _jax_params(jcfg, seed=5)
    sd = jax_params_to_state_dict(params, jcfg)
    path = str(tmp_path / "m.pth")
    save_torch_pth(path, sd)
    model, cfg = load_rwkv_checkpoint(path, device="cpu", quant="int8c")
    assert cfg.dtype == "bfloat16" and model.emb.weight.dtype == torch.bfloat16
    differs = 0
    for i in range(jcfg.n_layer):
        for part, name in TARGETS:
            key = f"blocks.{i}.{part}.{name}.weight"
            lin = getattr(getattr(model.blocks[i], part), name)
            q, scale = quantize_int8(torch.from_numpy(np.array(sd[key])))
            assert torch.equal(lin.q, q) and torch.equal(lin.scale, scale)
            q16, _ = quantize_int8(torch.from_numpy(np.array(sd[key])).bfloat16())
            differs += int(not torch.equal(q16, q))
    assert differs > 0          # a bf16 round first would have given other q
    assert isinstance(model.head, torch.nn.Module) and not isinstance(model.head, QuantLinear)


def test_quantize_rows_refuses_non_cpu_tensors_without_a_kernel():
    before = launch_counts()
    with pytest.raises(ValueError):
        quantize_rows(torch.empty(4, 16, device="meta"))
    with pytest.raises(ValueError, match="unknown quant mode"):
        quantize_model(None, "int4")
    assert launch_counts() == before
