"""The port's RWKV-5.x models (5.0, 5.1, 5.2; CPU, the kernels' plain
versions) against the JAX package on the same flat BlinkDL dicts.

Each version's dict is made from a JAX v5 init (2 layers, C=64, head 16, vocab
100, fp32) with the zero-initialised projections filled: 5.2 as it is; 5.1
with a per-head (H,) decay; 5.0 with that decay and no gate, as the
checkpoints of those versions hold them. Both packages load the same dict
(JAX ``state_dict_to_params``, the port ``load_state_dict_into``), and every
JAX reference is computed once per version (module fixture).

Tolerances (fp32): logits and states within 1e-4 of their largest value. The
JAX CPU route for v5 is the reference WKV, then y / 8 and GroupNorm(1e-5); the
port's is K1's plain version with GroupNorm(y, ln_x_eps = 64e-5) on the raw y,
equal up to that eps scaling and summation order (measured within 1e-5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.adapters.quant import quantize_tree
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.checkpoint.convert import state_dict_to_params as jax_state_dict_to_params
from rwkv_lm_ext_tpu.checkpoint.pth import sniff_model_config as jax_sniff_model_config
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.heads import embed_sequences as jax_embed_sequences
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu_torch.adapters.quant import quantize_model
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    checkpoint_config,
    load_rwkv_checkpoint,
    load_state_dict_into,
    save_rwkv_checkpoint,
)
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.infer.continuous import ContinuousBatcher
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.models.decode import decode_supported, rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.heads import embed_sequences
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV, TimeMixV5
from rwkv_lm_ext_tpu_torch.models.state import state_from_jax

torch.set_num_threads(1)  # tier-1 runs several pytest workers

BASE = dict(n_layer=2, n_embd=64, vocab_size=100, head_size=16)
SNIFFED = ("n_layer", "n_embd", "vocab_size", "dim_att", "dim_ffn", "head_size", "version")
VERSIONS = (5.0, 5.1, 5.2)
GREEDY = SamplingParams(temperature=0.0, top_p=1.0, alpha_presence=0.0, alpha_frequency=0.0,
                        token_stop=())
PROMPTS = ([5, 9, 23], [77, 3, 41, 8])
NEW = 5
REL = 1e-4


def v5_flat(version: float) -> dict:
    """The flat dict of a v5.x checkpoint, from a JAX v5 init."""
    jcfg = JaxModelConfig(**BASE, version=5.2, dtype="float32", param_dtype="float32")
    params = jax_init_rwkv_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    sd = jax_params_to_state_dict(params, jcfg)
    if version < 5.2:
        for key in [k for k in sd if k.endswith("att.time_decay")]:
            sd[key] = sd[key].mean(-1)                          # (H,): one decay a head
    if version < 5.1:
        sd = {k: v for k, v in sd.items() if not k.endswith(("att.gate.weight", "att.time_mix_g"))}
    return sd


def assert_close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def jax_greedy(jparams, jcfg, prompt, n):
    """The argmax loop over the JAX forward: n greedy tokens after prompt."""
    logits, state = jax_rwkv_forward(jparams, jcfg, jnp.asarray([prompt]))
    out = []
    for _ in range(n):
        out.append(int(jnp.argmax(logits[0, -1])))
        logits, state = jax_rwkv_forward(jparams, jcfg, jnp.asarray([[out[-1]]]), state)
    return out


@pytest.fixture(scope="module", params=VERSIONS, ids=lambda v: f"v{v}")
def case(request):
    """(version, flat dict, port model, JAX params, JAX cfg, tokens, JAX
    references): the full forward, a 6-token prefix and the T=1 step after
    it, the embeddings, and greedy tokens of each prompt."""
    version = request.param
    sd = v5_flat(version)
    jcfg = jax_sniff_model_config(sd, dtype="float32", param_dtype="float32")
    jparams = jax_state_dict_to_params(sd, jcfg)
    model = load_state_dict_into(RWKV(checkpoint_config(sd, dtype="float32"), device="cpu"), sd)
    tokens = np.random.default_rng(1).integers(4, 100, size=(2, 12))
    tokens[:, -1] = 1                                            # the embedding id ends the rows
    full, state = jax_rwkv_forward(jparams, jcfg, jnp.asarray(tokens))
    _, state6 = jax_rwkv_forward(jparams, jcfg, jnp.asarray(tokens[:, :6]))
    step, state7 = jax_rwkv_forward(jparams, jcfg, jnp.asarray(tokens[:, 6:7]), state6,
                                    t1_step=False)
    ref = dict(
        full=np.asarray(full), state=state_from_jax(state, 16), state6=state_from_jax(state6, 16),
        step=np.asarray(step), state7=state_from_jax(state7, 16),
        embed=np.asarray(jax_embed_sequences(jparams, jcfg, jnp.asarray(tokens))),
        greedy=[jax_greedy(jparams, jcfg, p, NEW) for p in PROMPTS],
    )
    return version, sd, model, jparams, jcfg, tokens, ref


def test_sniff_matches_jax_on_v5_dicts(case):
    version, sd, *_ = case
    got, want = sniff_model_config(sd), jax_sniff_model_config(sd)
    assert {f: getattr(got, f) for f in SNIFFED} == {f: getattr(want, f) for f in SNIFFED}
    assert got.version == version
    assert checkpoint_config(sd).version == version


def test_v5_logits_and_state_match_jax(case):
    version, sd, model, _, _, tokens, ref = case
    assert isinstance(model.blocks[0].att, TimeMixV5)
    assert (model.blocks[0].att.gate is None) == (version == 5.0)
    with torch.no_grad():
        logits, state = model(torch.from_numpy(tokens))
    assert_close(logits, ref["full"], "logits")
    for key in ("att_shift", "wkv", "ffn_shift"):
        assert_close(state[key], ref["state"][key], key)


def test_v5_chunked_prefill_equals_one_call(case):
    """Prefill in three calls (5 + 4 + 3 tokens) carries the state into what
    one call gives: logits and state within 1e-5 of max."""
    _, _, model, *_, tokens, ref = case
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        full, whole = model(t)
        state, parts = None, []
        for a, b in ((0, 5), (5, 9), (9, 12)):
            logits, state = model(t[:, a:b], state)
            parts.append(logits)
    assert_close(torch.cat(parts, 1), full, "chunked logits", rel=1e-5)
    for key in whole:
        assert_close(state[key], whole[key], key, rel=1e-5)


def test_v5_t1_step_matches_jax(case):
    """The port's T=1 step (B.9's plain version) against the JAX generic
    forward at T=1 (t1_step=False: the route JAX serves v5 on)."""
    _, _, model, *_, tokens, ref = case
    assert decode_supported(model.cfg)
    state6 = {k: torch.tensor(v) for k, v in ref["state6"].items()}
    with torch.no_grad():
        logits, state = rwkv_decode_step(model, torch.from_numpy(tokens[:, 6]), state6)
    assert_close(logits, ref["step"][:, 0], "step logits")
    for key in state:
        assert_close(state[key], ref["state7"][key], key)
    with pytest.raises(ValueError, match="fused_prep"):
        rwkv_decode_step(model, torch.from_numpy(tokens[:, 6]), state6, fused_prep=True)


def test_v5_embed_sequences_matches_jax(case):
    _, _, model, *_, tokens, ref = case
    with torch.no_grad():
        got = embed_sequences(model, torch.from_numpy(tokens))
    assert_close(got, ref["embed"], "embeddings")


def test_v5_greedy_generation_equals_jax(case):
    """GenerationEngine (chunked prefill, K-step blocks) and the continuous
    batcher give the JAX argmax loop's tokens."""
    _, _, model, *_, ref = case
    engine = GenerationEngine(model, chunk_len=2)
    for prompt, want in zip(PROMPTS, ref["greedy"]):
        assert engine.generate(prompt, max_tokens=NEW, sampling=GREEDY, block_size=2) == want
    batcher = ContinuousBatcher(engine, n_slots=2, sampling=GREEDY, block_size=4)
    rids = [batcher.submit(p, max_tokens=NEW) for p in PROMPTS]
    results = batcher.run()
    assert [results[r] for r in rids] == ref["greedy"]


def test_v5_checkpoint_round_trip(case, tmp_path):
    """save_rwkv_checkpoint -> load_rwkv_checkpoint keeps the version and the
    logits; a v5.0/5.1 file in the checkpoints' layout (per-head decay, v5.0
    without a gate) loads into the same model."""
    version, sd, model, *_, tokens, _ = case
    path = str(tmp_path / "m.pth")
    save_rwkv_checkpoint(model, path)
    loaded, cfg = load_rwkv_checkpoint(path, device="cpu", dtype="float32")
    raw = str(tmp_path / "raw.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, raw)
    from_raw, cfg_raw = load_rwkv_checkpoint(raw, device="cpu", dtype="float32")
    # the saved decay is (H, N), so 5.1 comes back as the equivalent 5.2
    assert cfg.version == (5.0 if version == 5.0 else 5.2) and cfg_raw.version == version
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        want, _ = model(t)
        for m in (loaded, from_raw):
            np.testing.assert_array_equal(m(t)[0].numpy(), want.numpy())


def test_v5_int8c_logits_match_jax_int8c(case):
    """int8c reaches TimeMixV5's projections (v5.0: no gate) as
    quantize_tree does; the forward within 1e-3 of max|logits| (as
    tests/test_torch_quant.py holds v6 int8c)."""
    version, sd, _, jparams, jcfg, tokens, _ = case
    model = load_state_dict_into(RWKV(checkpoint_config(sd, dtype="float32"), device="cpu"), sd)
    quantize_model(model, "int8c")
    n_quant = sum(type(m).__name__ == "QuantLinear" for m in model.modules())
    assert n_quant == BASE["n_layer"] * (8 if version >= 5.1 else 7)
    want, _ = jax_rwkv_forward(quantize_tree(jparams, "int8c"), jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens))
    assert_close(got, want, "int8c logits", rel=1e-3)


def test_v5_config_fields_and_state_keys():
    cfg = checkpoint_config(v5_flat(5.2))
    assert dataclasses.replace(cfg, dtype="float32").ln_x_eps == pytest.approx(64e-5)
    assert cfg.legacy_options == () and cfg.chunk_dependent_options == ()
    with pytest.raises(ValueError, match="version"):
        dataclasses.replace(cfg, version=5.3)
