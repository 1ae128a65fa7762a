"""Training the RWKV-5.x and RWKV-4 families through the port's trainer CLI
(CPU, the kernels' plain versions) against the JAX package's commands.

The parity cases run ``sft`` (``check_sft_against_jax``) and one contrastive
command (``check_trainer_against_jax``) of both CLIs on the same weights, with
the shared harness of tests/torch_stack_setup.py (SFT_DOC, TRAINER_DOC): the
loss at rtol 1e-5, the gradient norm at rtol 1e-4 and the trainables after
the steps within 1e-5 of their largest value or half the lr, each family's
tolerance as RWKV-6's in tests/test_torch_peft.py. The models: a JAX v5 init
(2 layers, C=64, head 16, vocab 1000, fp32) as 5.2, and as 5.0 with one decay
a head and no gate (the checkpoints of that version); JAX's RWKV-4 test model
(tests/test_rwkv4.py ``_v4_params``, C=32) at vocab 1000. Three steps for
v5.2 and v4, one for v5.0.

Also pinned: each command that stays refused on a family, with the JAX
failure behind it (ROADMAP C.26-C.29); the LoRA targets of each family by
name; a trained model's round trip through its saved files; and C.25,
``train.cli --platform cuda`` without a GPU exiting through
``resolve_device``'s message.
"""
import dataclasses
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.adapters import LoraConfig as JaxLoraConfig
from rwkv_lm_ext_tpu.adapters import init_lora_params as jax_init_lora_params
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.checkpoint.convert import state_dict_to_params as jax_state_dict_to_params
from rwkv_lm_ext_tpu.checkpoint.pth import sniff_model_config as jax_sniff_model_config
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.bidirectional import encoder_forward as jax_encoder_forward
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.train.losses import causal_lm_loss as jax_causal_lm_loss
from rwkv_lm_ext_tpu_torch.adapters.lora import LoraConfig, adapter_state_dict, init_lora_params
from rwkv_lm_ext_tpu_torch.adapters.quant import quantize_model
from rwkv_lm_ext_tpu_torch.adapters.lora import apply_lora
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    checkpoint_config,
    load_rwkv_checkpoint,
    load_state_dict_into,
    save_rwkv_checkpoint,
)
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.train import cli as pcli
from rwkv_lm_ext_tpu_torch.train.callbacks import save_model_checkpoint
from rwkv_lm_ext_tpu_torch.train.loop import sft_loss_fn
from tests.test_rwkv4 import CFG as JAX_V4_CFG
from tests.test_rwkv4 import _v4_params
from torch_stack_setup import (
    VOCAB,
    _tokenizer,
    check_sft_against_jax,
    check_trainer_against_jax,
    contrastive_data,
    sft_data,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

FAMILIES = ("v5.2", "v5.0", "v4")
STEPS = {"v5.2": 3, "v5.0": 1, "v4": 3}


def family_params(name: str):
    """(JAX params, JAX cfg) of a family's test model at the harness's
    vocabulary."""
    if name == "v4":
        jcfg = dataclasses.replace(JAX_V4_CFG, vocab_size=VOCAB)
        return _v4_params(jax.random.PRNGKey(0), jcfg), jcfg
    jcfg = JaxModelConfig(n_layer=2, n_embd=64, vocab_size=VOCAB, head_size=16, version=5.2,
                          dtype="float32", param_dtype="float32")
    params = jax_init_rwkv_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    for bp in params["blocks"]:
        for tree, name_ in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name_].shape
            tree[name_] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    if name == "v5.2":
        return params, jcfg
    sd = jax_params_to_state_dict(params, jcfg)
    for key in [k for k in sd if k.endswith("att.time_decay")]:
        sd[key] = sd[key].mean(-1)                              # (H,): one decay a head
    sd = {k: v for k, v in sd.items() if not k.endswith(("att.gate.weight", "att.time_mix_g"))}
    jcfg = jax_sniff_model_config(sd, dtype="float32", param_dtype="float32")
    assert jcfg.version == 5.0
    return jax_state_dict_to_params(sd, jcfg), jcfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("family_data")
    sft_data(d)
    return d


@pytest.mark.parametrize("family", FAMILIES)
def test_sft_lora_matches_the_jax_command(data, tmp_path, family):
    model, _ = check_sft_against_jax(str(data / "sft.jsonl"), tmp_path, ["--train-type", "lora"],
                                     steps=STEPS[family], params=family_params(family))
    assert model.cfg.version == {"v5.2": 5.2, "v5.0": 5.0, "v4": 4.0}[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_sft_full_tbptt_matches_the_jax_command(data, tmp_path, family):
    """``--train-type full --chunk-ctx 32``: the 64-token rows in two chunks,
    the state (v4: att_shift, aa, bb, pp, ffn_shift) carried with its
    gradient."""
    check_sft_against_jax(str(data / "sft.jsonl"), tmp_path,
                          ["--train-type", "full", "--chunk-ctx", "32"], steps=STEPS[family],
                          params=family_params(family))


def test_v4_lisa_matches_the_jax_command(data, tmp_path):
    """LISA over the RWKV-4 blocks: one block of two trains a step."""
    check_sft_against_jax(str(data / "sft.jsonl"), tmp_path,
                          ["--train-type", "full", "--lisa-k", "1", "--lisa-interval", "1"],
                          steps=2, params=family_params("v4"))


def test_simcse_on_v5_matches_the_jax_command(tmp_path_factory, tmp_path):
    data = contrastive_data(tmp_path_factory.mktemp("family_contrastive"))
    check_trainer_against_jax(data, tmp_path, "simcse", "simcse", [],
                              params=family_params("v5.2"))


@pytest.mark.parametrize("family", FAMILIES)
def test_lora_targets_are_the_jax_ones(family):
    """The adapted projections by name: JAX's ``_iter_targets`` on the same
    weights (v5.0 has no gate; RWKV-4 the key, value, receptance and output
    of its time mix), and QLoRA's quantized leaves are the same ones."""
    params, jcfg = family_params(family)
    want = set(jax_init_lora_params(jax.random.PRNGKey(0), params, JaxLoraConfig(r=4)))
    model = load_state_dict_into(RWKV(checkpoint_config(jax_params_to_state_dict(params, jcfg),
                                                         dtype="float32"), device="cpu"),
                                 jax_params_to_state_dict(params, jcfg))
    lc = LoraConfig(r=4, alpha=8.0)
    adapter = init_lora_params(model, lc, torch.Generator().manual_seed(0))
    assert set(adapter) == want
    quantize_model(model, "nf4")
    apply_lora(model, lc, adapter)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(3, VOCAB, size=(2, 16)))
    loss = sft_loss_fn(model, {"input_ids": tokens, "labels": tokens}, remat=False)
    loss.backward()
    grads = [p.grad for n, p in model.named_parameters() if "lora" in n]
    assert len(grads) == 2 * len(want) and all(g is not None and torch.isfinite(g).all()
                                               for g in grads)


def test_trained_models_round_trip_through_their_files(tmp_path):
    """A trained v5.0 and v4 model saved as the full trainer saves it loads
    back as the same family and weights; its adapter file has JAX's keys."""
    for family in ("v5.0", "v4"):
        params, jcfg = family_params(family)
        sd = jax_params_to_state_dict(params, jcfg)
        model = load_state_dict_into(RWKV(checkpoint_config(sd, dtype="float32"), device="cpu"), sd)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01)
        path = str(tmp_path / f"{family}.pth")
        save_model_checkpoint(model, path)
        back, cfg = load_rwkv_checkpoint(path, device="cpu", dtype="float32")
        assert cfg.version == model.cfg.version
        for (n, p), (m, q) in zip(model.state_dict().items(), back.state_dict().items()):
            assert n == m and torch.equal(p, q), n
        adapter = init_lora_params(model, LoraConfig(r=4), torch.Generator().manual_seed(0))
        keys = {re.sub(r"\.lora_[AB]$", "", k) for k in adapter_state_dict(adapter)}
        assert keys == set(adapter)


# ---------------------------------------------------------------------------
# What stays refused, by name, and the JAX failure behind each
# ---------------------------------------------------------------------------


def _checkpoint(tmp_path, family):
    params, jcfg = family_params(family)
    sd = jax_params_to_state_dict(params, jcfg)
    path = str(tmp_path / f"{family}.pth")
    save_rwkv_checkpoint(load_state_dict_into(RWKV(checkpoint_config(sd, dtype="float32"),
                                                   device="cpu"), sd), path)
    return path


def _run(command, path, data, tmp_path, *extra):
    with mock.patch.object(pcli, "WorldTokenizer", _tokenizer(pcli.WorldTokenizer)):
        pcli.main([command, "--model", path, "--train-data", str(data), "--output-dir",
                   str(tmp_path / "out"), "--platform", "cpu", "--max-steps", "1", *extra])


@pytest.mark.parametrize("command", ["bi-encoder", "simcse"])
def test_c26_rwkv4_embedding_commands_refused_as_jax_asserts(data, tmp_path, command):
    params, jcfg = family_params("v4")
    with pytest.raises(AssertionError):
        jax_rwkv_forward(params, jcfg, jnp.zeros((1, 4), jnp.int32), return_hidden=True,
                         return_logits=False)
    with pytest.raises(SystemExit, match="RWKV-4 model does not"):
        _run(command, _checkpoint(tmp_path, "v4"), data / "sft.jsonl", tmp_path)


@pytest.mark.parametrize("family", ["v4", "v5.2"])
def test_c27_state_tuning_refused_where_jax_fails_or_trains_nothing(data, tmp_path, family):
    """RWKV-4: JAX asserts on use_state_params. RWKV-5: JAX's v5 time mix
    takes no override, so the learnable states get a zero gradient."""
    params, jcfg = family_params(family)
    tokens = jnp.asarray(np.random.default_rng(2).integers(3, VOCAB, size=(2, 8)))
    if family == "v4":
        with pytest.raises(AssertionError):
            jax_rwkv_forward(params, jcfg, tokens, use_state_params=True)
    else:
        H, N = jcfg.n_head, jcfg.head_size
        for b in params["blocks"]:
            b["att"]["time_state"] = jnp.zeros((H, N, N), jnp.float32) + 0.1

        def loss(states):
            p = dict(params, blocks=[dict(b, att=dict(b["att"], time_state=s))
                                     for b, s in zip(params["blocks"], states)])
            logits, _ = jax_rwkv_forward(p, jcfg, tokens, use_state_params=True,
                                         wkv_backend="reference")
            return jax_causal_lm_loss(logits, tokens)

        grads = jax.grad(loss)([b["att"]["time_state"] for b in params["blocks"]])
        assert all(not np.asarray(g).any() for g in grads)
    with pytest.raises(SystemExit, match="needs an RWKV-6 model"):
        _run("sft", _checkpoint(tmp_path, family), data / "sft.jsonl", tmp_path,
             "--train-type", "state")


def test_c28_encoder_trainers_refused_on_rwkv5_as_jax_fails(data, tmp_path):
    params, jcfg = family_params("v5.2")
    with pytest.raises(KeyError):
        jax_encoder_forward(params, jcfg, jnp.ones((1, 8), jnp.int32))
    with pytest.raises(SystemExit, match="RWKV-6 time mix only"):
        _run("mlm", _checkpoint(tmp_path, "v5.2"), data / "sft.jsonl", tmp_path)


def test_c29_encoder_trainers_refuse_legacy_options(data, tmp_path):
    """JAX's encoder runs the plain v6 block: it trips on MishGLU's
    projections (KeyError) and ignores head_qk. The port refuses both."""
    jcfg = JaxModelConfig(n_layer=2, n_embd=64, vocab_size=VOCAB, head_size=16,
                          ffn_type="mishglu", dtype="float32", param_dtype="float32")
    with pytest.raises(KeyError):
        jax_encoder_forward(jax_init_rwkv_params(jax.random.PRNGKey(0), jcfg), jcfg,
                            jnp.ones((1, 8), jnp.int32))
    path = _checkpoint(tmp_path, "v5.2")
    real = pcli.load_rwkv_checkpoint
    for field, value in (("ffn_type", "mishglu"), ("head_qk", 8)):
        def load(p, **kw):
            model, c = real(p, **kw)
            return model, dataclasses.replace(c, version=6.0, **{field: value})

        with mock.patch.object(pcli, "load_rwkv_checkpoint", load):
            with pytest.raises(SystemExit, match="plain RWKV-6 ones"):
                _run("encoder-biencoder", path, data / "sft.jsonl", tmp_path)


def test_c25_platform_cuda_without_a_gpu_exits_by_name(data, tmp_path):
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(SystemExit, match="no CUDA device"):
            pcli.main(["sft", "--model", "m.pth", "--train-data", str(data / "sft.jsonl"),
                       "--output-dir", str(tmp_path), "--platform", "cuda"])
        with pytest.raises(SystemExit, match="no CUDA device"):
            pcli.main(["nli", "--model", "m.pth", "--train-data", "x.tsv", "--output-dir",
                       str(tmp_path), "--platform", "cuda"])
