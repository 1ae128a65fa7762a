"""The port's slot-LoRA (per-row adapters) and adapter registry against
merged adapters and against the JAX package.

Tolerances: a mixed-adapter batch equals each adapter merged within 1e-5
(fp32; the delta is summed in another order); over an int8 base within 1e-4
of the dequantized weights merged, as the JAX test holds it; the registry's
merged weights equal JAX's within 1e-6; greedy generation under an adapter
is token-equal to the JAX engine's.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.adapters import LoraConfig as JaxLoraConfig
from rwkv_lm_ext_tpu.adapters import build_slot_lora as jax_build_slot_lora
from rwkv_lm_ext_tpu.adapters import init_lora_params as jax_init_lora_params
from rwkv_lm_ext_tpu.adapters.registry import AdapterRegistry as JaxAdapterRegistry
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.infer.engine import GenerationEngine as JaxGenerationEngine
from rwkv_lm_ext_tpu.infer.sampling import SamplingParams as JaxSamplingParams
from rwkv_lm_ext_tpu_torch.adapters.lora import LoraConfig, apply_lora, merge_lora
from rwkv_lm_ext_tpu_torch.adapters.quant import dequantize_int8, quantize_int8, quantize_model
from rwkv_lm_ext_tpu_torch.adapters.registry import AdapterRegistry
from rwkv_lm_ext_tpu_torch.adapters.slot_lora import (
    SlotLoraLinear,
    apply_slot_stacks,
    build_slot_lora,
    has_slot_lora,
    init_slot_stacks,
    set_slot_idx,
    split_slot_stacks,
)
from rwkv_lm_ext_tpu_torch.checkpoint.convert import lora_tree_from_jax
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.infer.state_cache import PrefixStateCache
from torch_stack_setup import GREEDY, jax_params, torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers

LC, JLC = LoraConfig(r=4, alpha=16.0), JaxLoraConfig(r=4, alpha=16.0)
SP = SamplingParams(**GREEDY)


def _jax_adapter(params, seed, scale, lc=JLC):
    ad = jax_init_lora_params(jax.random.PRNGKey(seed), params, lc)
    for ab in ad.values():
        ab["B"] = scale * jnp.ones_like(ab["B"])
    return ad


@pytest.fixture(scope="module")
def setup():
    params, cfg = jax_params(seed=4)
    jads = {"a1": _jax_adapter(params, 1, 0.01), "a2": _jax_adapter(params, 2, -0.02)}
    return params, cfg, jads, {k: lora_tree_from_jax(v) for k, v in jads.items()}


def _merged(base, adapter, lc=LC):
    return merge_lora(apply_lora(copy.deepcopy(base), lc, adapter))


def _logits(model, tokens):
    with torch.no_grad():
        return model(tokens)[0]


def test_mixed_batch_equals_each_adapter_merged(setup):
    params, cfg, _, ads = setup
    base = torch_model(params, cfg)
    slot, ids = build_slot_lora(torch_model(params, cfg), ads, LC)
    assert ids == {"base": 0, "a1": 1, "a2": 2} and has_slot_lora(slot)
    tokens = torch.randint(0, 1000, (3, 8), generator=torch.Generator().manual_seed(3))
    set_slot_idx(slot, torch.tensor([0, 1, 2]))
    mixed = _logits(slot, tokens)
    for row, want_model in enumerate((base, _merged(base, ads["a1"]), _merged(base, ads["a2"]))):
        torch.testing.assert_close(mixed[row], _logits(want_model, tokens)[row],
                                   rtol=1e-5, atol=1e-5)
    assert not torch.allclose(mixed[1], _logits(base, tokens)[1], atol=1e-3)
    # one T=1 step per row through the decode route too
    set_slot_idx(slot, torch.tensor([2, 0, 1]))
    step = _logits(slot, tokens[:, :1])
    torch.testing.assert_close(step[0], _logits(_merged(base, ads["a2"]), tokens[:1, :1])[0],
                               rtol=1e-5, atol=1e-5)


def test_mixed_rank_adapters_are_zero_padded(setup):
    params, cfg, jads, ads = setup
    lc_small = LoraConfig(r=2, alpha=8.0)
    small = lora_tree_from_jax(_jax_adapter(params, 5, -0.03, JaxLoraConfig(r=2, alpha=8.0)))
    slot, _ = build_slot_lora(torch_model(params, cfg), {"a1": ads["a1"], "s": small},
                              {"a1": LC, "s": lc_small})
    mod = slot.blocks[0].att.key
    assert isinstance(mod, SlotLoraLinear) and mod.A.shape == (3, 128, 4)
    assert torch.all(mod.A[2, :, 2:] == 0) and torch.all(mod.B[2, 2:] == 0)
    tokens = torch.randint(0, 1000, (2, 6), generator=torch.Generator().manual_seed(4))
    set_slot_idx(slot, torch.tensor([1, 2]))
    mixed = _logits(slot, tokens)
    base = torch_model(params, cfg)
    torch.testing.assert_close(mixed[0], _logits(_merged(base, ads["a1"]), tokens)[0],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(mixed[1], _logits(_merged(base, small, lc_small), tokens)[1],
                               rtol=1e-5, atol=1e-5)


def test_pissa_and_the_embedding_are_refused_by_name(setup):
    params, cfg, _, ads = setup
    with pytest.raises(ValueError, match="PiSSA"):
        build_slot_lora(torch_model(params, cfg), {"a1": ads["a1"]}, LoraConfig(r=4, pissa=True))
    emb = {"emb": {"A": torch.zeros(1000, 4), "B": torch.zeros(4, 128)}}
    with pytest.raises(ValueError, match="embedding"):
        build_slot_lora(torch_model(params, cfg), {"e": emb}, LC)


def test_quantized_base(setup):
    """Over an int8 base the rows add their deltas to the dequantized
    product: the dequantized weights merged with the adapter."""
    params, cfg, _, ads = setup
    qslot, _ = build_slot_lora(quantize_model(torch_model(params, cfg), "int8"), ads, LC)
    set_slot_idx(qslot, torch.tensor([1]))
    dense = torch_model(params, cfg)
    with torch.no_grad():
        for block in dense.blocks:
            for part, names in ((block.att, ("receptance", "key", "value", "gate", "output")),
                                (block.ffn, ("key", "value", "receptance"))):
                for name in names:
                    w = getattr(part, name).weight
                    w.copy_(dequantize_int8(*quantize_int8(w)))
    tokens = torch.randint(0, 1000, (1, 8), generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(_logits(qslot, tokens), _logits(_merged(dense, ads["a1"]), tokens),
                               rtol=1e-4, atol=1e-4)


def test_generate_with_an_adapter_matches_the_jax_engine(setup):
    params, cfg, jads, ads = setup
    jslot, jids = jax_build_slot_lora(params, jads, JLC)
    jeng = JaxGenerationEngine(jslot, cfg, wkv_backend="reference", adapter_ids=jids)
    slot, ids = build_slot_lora(torch_model(params, cfg), ads, LC)
    eng = GenerationEngine(slot, adapter_ids=ids)
    prompt = [5, 9, 23, 411]
    outs = {}
    for name in (None, "a1", "a2"):
        want = jeng.generate(prompt, max_tokens=8, sampling=JaxSamplingParams(**GREEDY),
                             adapter=name)
        outs[name] = eng.generate(prompt, max_tokens=8, sampling=SP, adapter=name)
        assert outs[name] == [int(t) for t in want], name
    assert outs["a1"] != outs[None]
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.generate(prompt, max_tokens=2, sampling=SP, adapter="nope")


def test_prefix_cache_is_salted_per_adapter(setup):
    params, cfg, _, _ = setup
    strong = lora_tree_from_jax(_jax_adapter(params, 11, 0.05))
    slot, ids = build_slot_lora(torch_model(params, cfg), {"a1": strong}, LC)
    cache = PrefixStateCache(capacity=8, min_prefix=2)
    eng = GenerationEngine(slot, adapter_ids=ids, state_cache=cache)
    prompt = [5, 9, 23, 41]
    base_out = eng.generate(prompt, max_tokens=4, sampling=SP)
    chat_out = eng.generate(prompt, max_tokens=4, sampling=SP, adapter="a1")
    assert base_out != chat_out
    ext = prompt + [base_out[0]]
    hit_base = eng.generate(ext, max_tokens=4, sampling=SP)
    hit_chat = eng.generate(ext, max_tokens=4, sampling=SP, adapter="a1")
    assert cache.hits >= 2
    cold = GenerationEngine(slot, adapter_ids=ids)
    assert hit_base == cold.generate(ext, max_tokens=4, sampling=SP)
    assert hit_chat == cold.generate(ext, max_tokens=4, sampling=SP, adapter="a1")


def test_registry_materializes_the_jax_weights(setup):
    params, cfg, jads, ads = setup
    jreg = JaxAdapterRegistry(params)
    jreg.register("a1", jads["a1"], JLC)
    base = torch_model(params, cfg)
    reg = AdapterRegistry(base)
    reg.register("a1", ads["a1"], LC)
    assert reg.names() == jreg.names() == ["default", "a1"]
    assert reg.materialize("default") is base
    merged = reg.materialize("a1")
    assert reg.materialize("a1") is merged                    # cached
    want = jax_params_to_state_dict(jreg.materialize("a1"), cfg)
    got = merged.state_dict()
    for key in ("blocks.0.att.key.weight", "blocks.1.ffn.value.weight", "blocks.1.att.output.weight"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-6, atol=1e-6)
    # the base is untouched
    np.testing.assert_array_equal(base.state_dict()["blocks.0.att.key.weight"].numpy(),
                                  jax_params_to_state_dict(params, cfg)["blocks.0.att.key.weight"])
    # a PiSSA adapter against its own SVD init merges back to the base
    reg.register("p", ads["a1"], LoraConfig(r=4, pissa=True), pissa_init=ads["a1"])
    got = reg.materialize("p").state_dict()
    for key, value in base.state_dict().items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=1e-6)


def test_training_stacks_route_gradients_to_their_rows(setup):
    """init / apply / split: each batch row's loss reaches only its own
    adapter's row of the stacks, and split gives back per-name adapters."""
    params, cfg, _, _ = setup
    model = torch_model(params, cfg)
    stacks, ids = init_slot_stacks(model, LC, ["x", "y"], torch.Generator().manual_seed(0))
    assert ids == {"base": 0, "x": 1, "y": 2}
    for ab in stacks.values():
        ab["B"] = torch.full_like(ab["B"], 0.01)
    apply_slot_stacks(model, stacks, torch.tensor([1, 1]), LC)
    logits, _ = model(torch.randint(0, 1000, (2, 5), generator=torch.Generator().manual_seed(6)))
    logits.square().mean().backward()
    mod = model.blocks[1].ffn.key
    assert mod.A.grad[1].abs().sum() > 0
    assert torch.all(mod.A.grad[0] == 0) and torch.all(mod.A.grad[2] == 0)
    split = split_slot_stacks(stacks, ids)
    assert sorted(split) == ["x", "y"]
    assert torch.equal(split["y"]["blocks.0.att.key"]["A"], stacks["blocks.0.att.key"]["A"][2])
