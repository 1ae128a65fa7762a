"""The port's RWKV-6 slice (CPU, plain kernel versions) vs the JAX package on
the same weights, carried over as the flat BlinkDL dict that
checkpoint.convert.params_to_state_dict emits."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.checkpoint.convert import load_rwkv_checkpoint as jax_load_rwkv_checkpoint
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.checkpoint.pth import load_torch_pth, save_torch_pth
from rwkv_lm_ext_tpu.checkpoint.pth import sniff_model_config as jax_sniff_model_config
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.heads import embed_sequences as jax_embed_sequences
from rwkv_lm_ext_tpu.models.heads import pool_hidden as jax_pool_hidden
from rwkv_lm_ext_tpu.models.rwkv import layer_norm as jax_layer_norm
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.models.rwkv import time_mix_v6, time_mix_v6_fused
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    load_rwkv_checkpoint,
    load_state_dict_into,
    params_to_state_dict,
    save_rwkv_checkpoint,
)
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.config import EMB_ID, ModelConfig
from rwkv_lm_ext_tpu_torch.models.heads import embed_sequences, pool_hidden
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import KERNEL_OPS, RWKV
from rwkv_lm_ext_tpu_torch.models.state import state_from_jax, state_to_jax

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNIFFED = ("n_layer", "n_embd", "vocab_size", "dim_att", "dim_ffn", "head_size", "version")


def _jax_cfg(**kw):
    base = dict(n_layer=2, n_embd=128, vocab_size=1000, head_size=64,
                dtype="float32", param_dtype="float32")
    base.update(kw)
    return JaxModelConfig(**base)


def _jax_params(cfg, seed=0):
    """JAX init with the zero-initialised projections (att.output, ffn.value,
    ffn.receptance) filled, so every block does work."""
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    return params


def _port_model(params, jcfg):
    sd = jax_params_to_state_dict(params, jcfg)
    cfg = sniff_model_config(sd, dtype="float32")
    return load_state_dict_into(RWKV(cfg, device="cpu"), sd)


def _tokens(rng, B, T, vocab, emb_at):
    tokens = rng.integers(4, vocab, size=(B, T))
    for b, pos in enumerate(emb_at):
        tokens[b, pos] = EMB_ID
        tokens[b, pos + 1:] = 0
    return tokens


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def test_time_mix_matches_both_jax_routes():
    """Port TimeMix (K2 + projections + K1, plain on the CPU) vs JAX
    time_mix_v6_fused (Pallas prologue and fused WKV, interpreted) and vs
    ln1 + the unfused chunked time_mix_v6, with carried shift/WKV state."""
    jcfg = _jax_cfg(vocab_size=100)
    params = _jax_params(jcfg)
    model = _port_model(params, jcfg)
    bp, blk = params["blocks"][1], model.blocks[1]
    rng = np.random.default_rng(5)
    B, T, C, H, N = 2, 32, 128, 2, 64
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    shift = rng.normal(size=(B, C)).astype(np.float32)
    wkv0 = (0.1 * rng.normal(size=(B, H, N, N))).astype(np.float32)
    fused = time_mix_v6_fused(bp, jcfg, jnp.asarray(x), jnp.asarray(shift),
                              jnp.asarray(wkv0), interpret=True)
    unfused = time_mix_v6(bp["att"], jcfg, jax_layer_norm(jnp.asarray(x), bp["ln1"]),
                          jnp.asarray(shift), jnp.asarray(wkv0), wkv_backend="chunked")
    with torch.no_grad():
        out, att_shift, wkv = blk.att(torch.from_numpy(x), blk.ln1, torch.from_numpy(shift),
                                      torch.from_numpy(wkv0), KERNEL_OPS)
    for want_out, want_shift, want_wkv in (fused, unfused):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(att_shift.numpy(), np.asarray(want_shift), rtol=0, atol=1e-5)
        np.testing.assert_allclose(wkv.numpy(), np.asarray(want_wkv), rtol=3e-4, atol=3e-4)


def test_embed_sequences_and_final_state_match_jax():
    jcfg = _jax_cfg()
    params = _jax_params(jcfg, seed=1)
    model = _port_model(params, jcfg)
    tokens = _tokens(np.random.default_rng(2), 3, 64, 1000, emb_at=(5, 40, 63))
    want = jax_embed_sequences(params, jcfg, jnp.asarray(tokens))
    _, want_state = jax_rwkv_forward(params, jcfg, jnp.asarray(tokens),
                                     return_hidden=True, return_logits=False)
    with torch.no_grad():
        got = embed_sequences(model, torch.from_numpy(tokens))
        _, got_state = model(torch.from_numpy(tokens), return_hidden=True, return_logits=False)
    assert got.shape == (3, 128) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4)
    want_state = state_from_jax({k: np.asarray(v) for k, v in want_state.items()}, 64)
    for key in ("att_shift", "wkv", "ffn_shift"):
        _close(got_state[key].numpy(), want_state[key], 1e-4)


def test_forward_carries_state_like_jax():
    """Two chunks with the state carried between them; the port's state,
    packed for JAX, continues the JAX forward to the same logits."""
    jcfg = _jax_cfg()
    params = _jax_params(jcfg, seed=3)
    model = _port_model(params, jcfg)
    tokens = np.random.default_rng(4).integers(4, 1000, size=(2, 48))
    a, b = tokens[:, :20], tokens[:, 20:]
    want1, jst1 = jax_rwkv_forward(params, jcfg, jnp.asarray(a))
    want2, _ = jax_rwkv_forward(params, jcfg, jnp.asarray(b), jst1)
    with torch.no_grad():
        got1, st1 = model(torch.from_numpy(a))
        got2, _ = model(torch.from_numpy(b), st1)
    _close(got1.numpy(), want1, 1e-4)
    _close(got2.numpy(), want2, 1e-4)
    as_jax = {k: jnp.asarray(v) for k, v in state_to_jax({k: v.numpy() for k, v in st1.items()}).items()}
    assert as_jax["wkv"].shape == jst1["wkv"].shape
    cont, _ = jax_rwkv_forward(params, jcfg, jnp.asarray(b), as_jax)
    _close(got2.numpy(), cont, 1e-4)


def test_pth_from_jax_loads_in_port(tmp_path):
    jcfg = _jax_cfg()
    params = _jax_params(jcfg, seed=5)
    path = str(tmp_path / "jax.pth")
    save_torch_pth(path, jax_params_to_state_dict(params, jcfg))
    model, cfg = load_rwkv_checkpoint(path, device="cpu", dtype="float32")
    jax_cfg = jax_sniff_model_config(load_torch_pth(path))
    assert [getattr(cfg, f) for f in SNIFFED] == [getattr(jax_cfg, f) for f in SNIFFED]
    tokens = np.random.default_rng(6).integers(4, 1000, size=(2, 16))
    want, _ = jax_rwkv_forward(params, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens))
    _close(got.numpy(), want, 1e-4)


def test_pth_from_port_loads_in_jax(tmp_path):
    cfg = ModelConfig(n_layer=2, n_embd=128, vocab_size=1000, head_size=64, dtype="float32")
    sd = init_rwkv_params(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    g = torch.Generator().manual_seed(8)
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight", "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=g) * 0.5 / sd[key].shape[1] ** 0.5
    model = load_state_dict_into(RWKV(cfg, device="cpu"), sd)
    path = str(tmp_path / "port.pth")
    save_rwkv_checkpoint(model, path)
    jparams, jcfg = jax_load_rwkv_checkpoint(path, wkv_dispatch="exact", dtype="float32")
    assert [getattr(cfg, f) for f in SNIFFED] == [getattr(jcfg, f) for f in SNIFFED]
    tokens = np.random.default_rng(9).integers(4, 1000, size=(2, 16))
    want, _ = jax_rwkv_forward(jparams, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = model(torch.from_numpy(tokens))
    _close(got.numpy(), want, 1e-4)
    back = params_to_state_dict(model)
    for key, value in back.items():
        np.testing.assert_array_equal(value, sd[key].numpy())


def test_init_emits_the_jax_flat_schema():
    """Same keys and shapes as JAX init -> params_to_state_dict, the same
    deterministic schedules, and the port's module loads it."""
    jcfg = _jax_cfg(n_layer=3)
    want = jax_params_to_state_dict(jax_init_rwkv_params(jax.random.PRNGKey(0), jcfg), jcfg)
    cfg = ModelConfig(n_layer=3, n_embd=128, vocab_size=1000, head_size=64, dtype="float32")
    got = init_rwkv_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    random = ("_w1", "_w2", "att.receptance.weight", "att.key.weight", "att.value.weight",
              "att.gate.weight", "ffn.key.weight", "emb.weight", "head.weight")
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        if not key.endswith(random):
            np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-6, atol=1e-7, err_msg=key)
    load_state_dict_into(RWKV(cfg, device="cpu"), got)


@pytest.mark.parametrize("pooling_type", ["weightedmean", "weightedmean_runtime", "lasttoken", "avg"])
def test_pool_hidden_matches_jax(pooling_type):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(4, 12, 16)).astype(np.float32)
    actual_len = np.array([1, 5, 10, 11])
    want = jax_pool_hidden(jnp.asarray(x), jnp.asarray(actual_len), pooling_type)
    got = pool_hidden(torch.from_numpy(x), torch.from_numpy(actual_len), pooling_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rwkv_lm_ext_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for name in ('models.bidirectional', 'ops.wkv', 'ops.decode_fused', 'train.cli', 'serve.cli',\n"
        "             'infer.continuous', 'infer.beam', 'adapters.slot_lora', 'serve.webui',\n"
        "             'infer.encoders', 'models.heads', 'train.losses', 'train.loop',\n"
        "             'train.callbacks', 'data.collators', 'data.nli', 'eval.sts',\n"
        "             'adapters.registry', 'checkpoint.convert', 'models.rwkv4', 'ops.wkv4',\n"
        "             'data.tokenizer_json', 'data.binidx', 'data.pretrain', 'data.preprocess',\n"
        "             'data.converters', 'data.tokenizer_glm', 'eval.cli', 'eval.tasks',\n"
        "             'eval.mteb_adapter', 'apps.kg', 'apps.rag', 'utils.profiling',\n"
        "             'models.collect', 'ops.wkv_collect', 'infer.speculative',\n"
        "             'parallel.distributed', 'parallel.mesh', 'parallel.tp',\n"
        "             'parallel.pipeline', 'parallel.sequence', 'ops.wkv_chunked'):\n"
        "    assert p.__name__ + '.' + name in sys.modules, name\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0].startswith('jax')\n"
        "             or m.split('.')[0] == 'rwkv_lm_ext_tpu')\n"
        "print(len([m for m in sys.modules if m.startswith('rwkv_lm_ext_tpu_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 15   # every port module was imported


def test_fp32_shift_states_are_copies():
    """Each block's new shift states are (B, C) tensors of their own: a view
    of an fp32 (B, T, C) activation would hold it until the forward returns."""
    jcfg = _jax_cfg()
    model = _port_model(_jax_params(jcfg), jcfg)
    shifts = []
    for blk in model.blocks:
        for mod in (blk.att, blk.ffn):
            mod.register_forward_hook(lambda m, args, out: shifts.append(out[1]))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(4, 1000, size=(2, 16)))
    with torch.inference_mode():
        model(tokens, reference=True)
    assert len(shifts) == 2 * jcfg.n_layer
    for s in shifts:
        assert s.shape == (2, jcfg.n_embd) and s.dtype == torch.float32
        assert s.untyped_storage().nbytes() == s.numel() * s.element_size()
