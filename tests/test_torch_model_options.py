"""The legacy RWKV-LM options in the port (CPU, the kernels' plain versions)
against the JAX package: head_qk, tiny attention, MishGLU, pre_ffn and
my_pos_emb (JAX tests/test_model_options.py's geometry: 2 layers, C=64, head
16, vocab 100, fp32), each with its weights perturbed from their zero init so
that the option does work, carried over from the JAX parameter tree by
``state_dict_from_jax_tree``.

Also pinned: ROADMAP C.21 (JAX's head_qk, tiny attention and my_pos_emb see
only one call's tokens, so a chunked prefill answers otherwise than one call;
the port's serving entry points refuse them), C.22 (JAX's flat dict cannot
carry the options' weights) and what the trainers still refuse: state tuning
on RWKV-4/5 and the encoder trainers on a model with an option (where the JAX
commands fail or train nothing; tests/test_torch_family_train.py pins the
JAX side), while ``sft`` trains a checkpoint with dropout as JAX's does,
without it.

Tolerance (fp32): logits and states within 1e-4 of their largest value.
"""
import dataclasses
import json
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.checkpoint.convert import state_dict_to_params as jax_state_dict_to_params
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    load_state_dict_into,
    save_rwkv_checkpoint,
    state_dict_from_jax_tree,
)
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.infer.continuous import ContinuousBatcher
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.models.decode import decode_supported
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.models.state import state_from_jax
from rwkv_lm_ext_tpu_torch.serve import cli as serve_cli
from rwkv_lm_ext_tpu_torch.train import cli as train_cli

torch.set_num_threads(1)  # tier-1 runs several pytest workers

BASE = dict(n_layer=2, n_embd=64, vocab_size=100, head_size=16)
OPTIONS = {
    "head_qk": dict(head_qk=32),
    "tiny_att": dict(tiny_att_dim=16, tiny_att_layer=1),
    "mishglu": dict(ffn_type="mishglu"),
    "pre_ffn": dict(pre_ffn=1),
    "my_pos_emb": dict(my_pos_emb=4),
    "v5.2 pre_ffn mishglu": dict(version=5.2, pre_ffn=1, ffn_type="mishglu"),
}
CHUNK_DEPENDENT = ("head_qk", "tiny_att", "my_pos_emb")
GREEDY = SamplingParams(temperature=0.0, top_p=1.0, alpha_presence=0.0, alpha_frequency=0.0,
                        token_stop=())


def jax_option_params(options: dict):
    """(JAX params, JAX cfg): the init, with the zero-initialised projections
    and the options' zero weights (head_q, tiny_q, pos_emb_*, ffn_pre's
    value and receptance) filled from a seed."""
    jcfg = JaxModelConfig(**BASE, **options, dtype="float32", param_dtype="float32")
    params = jax_init_rwkv_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)

    def fill(tree, name, scale):
        tree[name] = jnp.asarray(rng.normal(size=tree[name].shape) * scale, jnp.float32)

    for bp in params["blocks"]:
        for tree in (bp["att"], bp["ffn"], bp.get("ffn_pre", {})):
            for name in ("output", "value", "receptance"):
                if name in tree and not np.asarray(tree[name]).any():
                    fill(tree, name, 0.5 / np.sqrt(tree[name].shape[0]))
        for name in ("tiny_q", "pos_emb_x", "pos_emb_y"):
            if name in bp:
                fill(bp, name, 0.3)
    if "head_q" in params:
        fill(params, "head_q", 0.3)
    return params, jcfg


def port_model(params, options: dict):
    cfg = ModelConfig(**BASE, **options, dtype="float32")
    return load_state_dict_into(RWKV(cfg, device="cpu"), state_dict_from_jax_tree(params, cfg))


def assert_close(got, want, what, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


TOKENS = np.random.default_rng(2).integers(4, 100, size=(2, 10))


@pytest.fixture(scope="module", params=list(OPTIONS))
def option(request):
    """(name, options, port model, JAX references over TOKENS): one call of
    10 tokens (logits, state), a 6-token prefix's state, the T=1 call after
    it (t1_step=False) and the 4-token call after it, each computed once."""
    options = OPTIONS[request.param]
    params, jcfg = jax_option_params(options)
    whole, state = jax_rwkv_forward(params, jcfg, jnp.asarray(TOKENS))
    _, state6 = jax_rwkv_forward(params, jcfg, jnp.asarray(TOKENS[:, :6]))
    step, state7 = jax_rwkv_forward(params, jcfg, jnp.asarray(TOKENS[:, 6:7]), state6,
                                    t1_step=False)
    tail, _ = jax_rwkv_forward(params, jcfg, jnp.asarray(TOKENS[:, 6:]), state6)
    ref = dict(whole=np.asarray(whole), state=state_from_jax(state, 16),
               state6=state_from_jax(state6, 16), step=np.asarray(step),
               state7=state_from_jax(state7, 16), tail=np.asarray(tail))
    return request.param, options, port_model(params, options), ref


def test_option_forward_matches_jax(option):
    name, options, model, ref = option
    assert not decode_supported(model.cfg)
    with torch.no_grad():
        logits, state = model(torch.from_numpy(TOKENS))
    assert_close(logits, ref["whole"], f"{name} logits")
    for key in state:
        assert_close(state[key], ref["state"][key], f"{name} {key}")
    if "pre_ffn" in options:
        assert model.blocks[0].att is None and "blocks.0.ffnPre.key.weight" in model.state_dict()


def test_option_t1_call_matches_jax_t1(option):
    """A T=1 call after a 6-token prefix (the generic forward: no option
    model takes the decode step) against JAX at T=1, t1_step=False."""
    name, _, model, ref = option
    st = {k: torch.tensor(v) for k, v in ref["state6"].items()}
    with torch.no_grad():
        got, state = model(torch.from_numpy(TOKENS[:, 6:7]), st)
    assert_close(got, ref["step"], f"{name} T=1 logits")
    for key, value in ref["state7"].items():
        assert_close(state[key], value, f"{name} T=1 {key}")


def test_c21_chunked_prefill_and_serving_refusals(option):
    """ROADMAP C.21: for head_qk, tiny attention and my_pos_emb, JAX's logits
    over the last 4 tokens differ between one call of 10 tokens and a
    6-token call carried into a 4-token call (the option sees one call's
    tokens only), and the port's GenerationEngine, ContinuousBatcher and
    serve.cli refuse such a model by name. MishGLU and pre_ffn carry their
    state exactly (within 1e-5 of max), and the engine takes them."""
    name, options, model, ref = option
    gap = np.abs(ref["whole"][:, 6:] - ref["tail"]).max() / np.abs(ref["tail"]).max()
    if name not in CHUNK_DEPENDENT:
        assert gap <= 1e-5, f"{name}: chunked prefill moved the logits by {gap} of max"
        GenerationEngine(model)
        return
    assert gap > 1e-4, f"{name}: chunked prefill equals one call (gap {gap} of max)"
    field = next(iter(options))
    with pytest.raises(ValueError, match=field):
        GenerationEngine(model)
    with pytest.raises(ValueError, match=field):
        ContinuousBatcher(types.SimpleNamespace(cfg=model.cfg))
    with mock.patch.object(serve_cli, "_config", lambda path, overrides: model.cfg):
        with pytest.raises(SystemExit, match=field):
            serve_cli.build_service(serve_cli.parse_args(["--model", "m.pth", "--platform", "cpu"]))


def test_option_model_greedy_generation_equals_jax():
    """pre_ffn and MishGLU carry their state exactly, so the engine serves
    them (its decode steps run the generic forward at T=1): the JAX argmax
    loop's tokens."""
    options = OPTIONS["v5.2 pre_ffn mishglu"]
    params, jcfg = jax_option_params(options)
    prompt = [5, 9, 23, 7]
    logits, st = jax_rwkv_forward(params, jcfg, jnp.asarray([prompt]))
    want = []
    for _ in range(4):
        want.append(int(jnp.argmax(logits[0, -1])))
        logits, st = jax_rwkv_forward(params, jcfg, jnp.asarray([[want[-1]]]), st)
    engine = GenerationEngine(port_model(params, options), chunk_len=2)
    assert engine.generate(prompt, max_tokens=4, sampling=GREEDY, block_size=2) == want


def test_c22_jax_flat_dict_cannot_carry_the_options():
    """ROADMAP C.22: JAX params_to_state_dict flattens MishGLU's ffn.aa (C,
    F) to (1, 1, C*F) and drops head_q/head_k, tiny_*, pos_emb_* and ffn_pre;
    state_dict_to_params reads none of them back, and stops at the MishGLU
    block's missing ffn.key. The port's carrier keeps each in the
    reference's key and layout."""
    options = dict(ffn_type="mishglu", head_qk=8, tiny_att_dim=16, tiny_att_layer=1,
                   pre_ffn=1, my_pos_emb=4)
    params, jcfg = jax_option_params(options)
    C, F = jcfg.n_embd, jcfg.dim_ffn
    flat = jax_params_to_state_dict(params, jcfg)
    assert flat["blocks.0.ffn.aa"].shape == (1, 1, C * F)
    assert not any(k.startswith(("head_q", "head_k")) or "tiny_" in k or "pos_emb" in k
                   or "ffn_pre" in k for k in flat)
    with pytest.raises(KeyError, match="ffn.key"):
        jax_state_dict_to_params(flat, jcfg)
    sd = state_dict_from_jax_tree(params, ModelConfig(**BASE, **options))
    assert sd["blocks.0.ffn.aa.weight"].shape == (F, C)
    assert sd["head_q.weight"].shape == (8, C) and sd["blocks.1.tiny_v.weight"].shape == (C, C)
    assert {"blocks.0.pos_emb_x", "blocks.0.pos_emb_y", "blocks.0.ffnPre.key.weight"} <= set(sd)
    assert not any(k.startswith("blocks.0.att.") for k in sd)


def _sft_files(tmp_path, cfg):
    """A checkpoint of cfg's family and a one-row sft jsonl."""
    path = str(tmp_path / "m.pth")
    sd = init_rwkv_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    save_rwkv_checkpoint(load_state_dict_into(RWKV(cfg, device="cpu"), sd), path)
    data = tmp_path / "sft.jsonl"
    data.write_text(json.dumps({"instruction": "say", "input": "hi", "output": "hello"}) + "\n")
    return path, str(data)


def _sft(path, data, tmp_path, train_type="lora", command="sft"):
    argv = [command, "--model", path, "--train-data", data, "--output-dir", str(tmp_path / "out"),
            "--platform", "cpu", "--max-steps", "1", "--log-every", "1", "--micro-bsz", "1"]
    train_cli.main(argv + (["--train-type", train_type] if command == "sft" else []))


@pytest.mark.parametrize("version,train_type", [(5.2, "state"), (4.0, "states")])
def test_trainers_refuse_rwkv4_and_rwkv5(tmp_path, version, train_type):
    """State tuning needs RWKV-6 (the JAX trainer asserts on v4 and gives v5's
    states no gradient); every other sft train type takes both families."""
    head = 64 if version < 5 else 16
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=head, version=version,
                      dtype="float32")
    path, data = _sft_files(tmp_path, cfg)
    with pytest.raises(SystemExit, match=f"needs an RWKV-6 model: on RWKV-{version:g}"):
        _sft(path, data, tmp_path, train_type)


@pytest.mark.parametrize("field,value", [("head_qk", 8), ("ffn_type", "mishglu"),
                                         ("dropout", 0.1)])
def test_trainers_refuse_legacy_options_and_dropout(tmp_path, field, value, capsys):
    """No checkpoint carries these (the sniffer cannot see them), so the
    loader is made to return a config with one set. The encoder trainers
    exit by name on an option before they build anything; ``sft`` trains a
    model with dropout without it, as the JAX trainer does (its first loss
    is the one without dropout, bit for bit)."""
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=16, dtype="float32")
    path, data = _sft_files(tmp_path, cfg)
    real = train_cli.load_rwkv_checkpoint

    def load(p, **kw):
        model, c = real(p, **kw)
        return model, dataclasses.replace(c, **{field: value})

    if field != "dropout":
        with mock.patch.object(train_cli, "load_rwkv_checkpoint", load):
            with pytest.raises(SystemExit, match=field.split("_")[0]):
                _sft(path, data, tmp_path, command="mlm")
        return
    losses = []
    for loader in (real, load):
        capsys.readouterr()
        with mock.patch.object(train_cli, "load_rwkv_checkpoint", loader):
            _sft(path, data, tmp_path)
        losses += [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step 0")]
    assert len(losses) == 2
    assert json.loads(losses[0].split(": ", 1)[1])["loss"] == \
        json.loads(losses[1].split(": ", 1)[1])["loss"]
