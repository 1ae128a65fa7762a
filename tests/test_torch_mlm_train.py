"""The port's encoder training slice (CPU, the kernels' plain versions) against
the JAX package on the same weights and batches: the MLM loss, the masking
collators, full-parameter ``mlm`` and ``mae`` losses, gradients and optimizer
steps, bf16 compute over fp32 master weights, and the trainer CLI.

Tolerances: the loss function alone within 1e-6; the slice's loss and every
parameter's gradient within 1e-4 of the largest |JAX value| of that tensor
(the JAX forward runs its chunked WKV factoring, the port the sequential
recurrence, both fp32); parameters after three steps within 1e-5 (or 5e-3 of
the steps' lr, see the test); the bf16 loss within 2e-2 relative.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.checkpoint.pth import load_torch_pth
from rwkv_lm_ext_tpu.config import TrainConfig as JaxTrainConfig
from rwkv_lm_ext_tpu.data import collators as jcollators
from rwkv_lm_ext_tpu.models import bidirectional as jbi
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.heads import mlm_logits as jax_mlm_logits
from rwkv_lm_ext_tpu.train.loop import make_train_step as jax_make_train_step
from rwkv_lm_ext_tpu.train.losses import mlm_loss as jax_mlm_loss
from rwkv_lm_ext_tpu.train.optim import decay_mask as jax_decay_mask
from rwkv_lm_ext_tpu.train.optim import lr_scale_labels as jax_lr_scale_labels
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    load_rwkv_checkpoint,
    load_state_dict_into,
    one_layer_decoder_from_jax,
    save_rwkv_checkpoint,
)
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.config import ModelConfig, TrainConfig
from rwkv_lm_ext_tpu_torch.data import collators
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.train.loop import mae_loss_fn, make_train_step, mlm_loss_fn
from rwkv_lm_ext_tpu_torch.train.losses import mlm_loss
from rwkv_lm_ext_tpu_torch.train.optim import (
    apply_trainable_mask,
    decay_mask,
    lr_scale_labels,
    trainable_mask,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 300
# the trainer's default learning rates
STEP_KW = dict(lr_init=3e-4, lr_final=1e-5, warmup_steps=1, total_steps=3, weight_decay=0.01,
               grad_clip=1.0, grad_checkpoint=False)


def _close(got, want, rel, name=""):
    got, want = (a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
                 for a in (got, want))
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (name, err, np.abs(want).max())


def _fill(att, ffn, rng):
    """Fill what the initialiser leaves at zero or at 1e-4 (the output-side
    projections, the low-rank mixers): with them every parameter's gradient
    stands well above rounding, which the comparison of Adam steps needs
    (Adam divides a gradient by its own size)."""
    for tree, name in ((att, "output"), (ffn, "value"), (ffn, "receptance"), (att, "time_maa_w1"),
                       (att, "time_maa_w2"), (att, "time_decay_w1"), (att, "time_decay_w2")):
        shape = tree[name].shape
        tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[-2]), jnp.float32)


def _setup(seed=0, decoder=False, **torch_cfg):
    """fp32 2-layer model, n_embd 128, head 64, on both sides (see _fill);
    with ``decoder`` also the RetroMAE one-layer decoder."""
    jcfg = JaxModelConfig(n_layer=2, n_embd=128, vocab_size=VOCAB, head_size=64,
                          dtype="float32", param_dtype="float32")
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        _fill(bp["att"], bp["ffn"], rng)
    params["emb"] = jnp.asarray(rng.normal(size=params["emb"].shape) * 0.3, jnp.float32)
    sd = jax_params_to_state_dict(params, jcfg)
    cfg = sniff_model_config(sd, **{"dtype": "float32", **torch_cfg})
    model = load_state_dict_into(RWKV(cfg, device="cpu"), sd)
    if decoder:
        dec = jbi.init_one_layer_decoder(jax.random.PRNGKey(seed + 1), jcfg)
        _fill(dec["att"], dec["ffn"], rng)
        params["onelayer_decoder"] = dec
        model.onelayer_decoder = one_layer_decoder_from_jax(dec, cfg)
    return jcfg, params, model


def _examples(seed, n=3, longest=15):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(4, VOCAB, size=int(m)).tolist()}
            for m in rng.integers(5, longest + 1, size=n)]


def _tb(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
            for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat_grads(grads, jcfg, cfg):
    """A JAX gradient tree in the port's flat names (the decoder's under
    ``onelayer_decoder.``)."""
    flat = dict(jax_params_to_state_dict(grads, jcfg))
    if "onelayer_decoder" in grads:
        dec = one_layer_decoder_from_jax(grads["onelayer_decoder"], cfg)
        flat.update({f"onelayer_decoder.{k}": v.numpy() for k, v in dec.state_dict().items()})
    return flat


def _compare_tree(model, flat, rel, what, floor=0.0):
    """Every tensor within ``rel`` of its largest |JAX value|, or within
    ``floor`` where that is larger."""
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(flat)
    largest = max(np.abs(v).max() for v in flat.values())
    for name, p in model.named_parameters():
        got = p.grad if what == "grad" else p
        want = flat[name].reshape(p.shape)
        if got is None:                       # a leaf the loss does not reach
            assert name == "head.weight" and not want.any()
            continue
        if np.abs(want).max() < 1e-9 * largest:
            # a gradient that is zero analytically (the decoder's time_maa_w:
            # its decay at step 0 scales a zero state, and later steps see no
            # token shift) is rounding noise of JAX's chunked factoring
            assert np.abs(got.detach().numpy()).max() < 1e-9 * largest, name
            continue
        err = np.abs(got.detach().numpy().astype(np.float64) - want).max()
        assert err <= max(rel * np.abs(want).max(), floor), (what, name, err, np.abs(want).max())


def test_mlm_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(2, 6)).astype(np.int32)
    labels[0, :3] = labels[1, 4] = -100
    want, want_g = jax.value_and_grad(jax_mlm_loss)(jnp.asarray(logits), jnp.asarray(labels))
    lt = torch.from_numpy(logits).requires_grad_()
    got = mlm_loss(lt, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    _close(lt.grad, want_g, 1e-6)
    none = mlm_loss(torch.from_numpy(logits), torch.full((2, 6), -100))
    assert float(none) == float(jax_mlm_loss(jnp.asarray(logits), jnp.full((2, 6), -100))) == 0.0


@pytest.mark.parametrize("kw", [dict(), dict(emb_id=1, seed=3), dict(mask_prob=0.01, seed=4),
                                dict(segments=True, seed=5)])
def test_mlm_collate_matches_jax(kw):
    kw = dict(kw)
    examples = _examples(1, n=5, longest=20)
    if kw.pop("segments", False):
        for e in examples:
            e["segment_ids"] = (np.arange(len(e["input_ids"])) // 2).tolist()
    got, want = collators.mlm_collate(examples, 16, **kw), jcollators.mlm_collate(examples, 16, **kw)
    assert sorted(got) == sorted(want) == ["input_ids", "labels"]
    for key in got:
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])
    assert (got["labels"] != -100).any(axis=1).all()


@pytest.mark.parametrize("bag_of_words", [False, True])
def test_mae_collate_and_whole_word_mask_match_jax(bag_of_words):
    examples = _examples(2, n=4, longest=20)
    kw = dict(bag_of_words=bag_of_words, vocab_size=VOCAB, seed=6)
    got, want = collators.mae_collate(examples, 16, **kw), jcollators.mae_collate(examples, 16, **kw)
    assert sorted(got) == sorted(want) and ("bag_word_weight" in got) == bag_of_words
    for key in got:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    seg = [0, 0, 1, 2, 2, 2, -1, 3]
    np.testing.assert_array_equal(
        collators.whole_word_mask(8, seg, 0.5, np.random.default_rng(7)),
        jcollators.whole_word_mask(8, seg, 0.5, np.random.default_rng(7)))


def test_full_tree_optimizer_groups_match_jax():
    jcfg, params, model = _setup(decoder=True)
    named = list(model.named_parameters())
    assert all(trainable_mask(model, "full").values())
    flat_labels = _flat_names(jax_lr_scale_labels(params))
    flat_decay = _flat_names(jax_decay_mask(params))
    labels, decays = lr_scale_labels(named), decay_mask(named)
    assert {n: labels[n] for n in labels} == flat_labels
    assert decays == flat_decay
    assert labels["blocks.0.att.time_decay"] == "2x" and not decays["blocks.0.att.time_maa_x"]
    assert decays["blocks.1.att.time_faaaa"] and decays["emb.weight"]


def _flat_names(tree):
    """A JAX tree of per-leaf labels -> {the port's flat parameter name: label}."""
    out = {}

    def put(prefix, sub):
        for name, value in sub.items():
            if isinstance(value, dict) and name in ("ln0", "ln1", "ln2", "ln_out", "ln_x"):
                out[f"{prefix}{name}.weight"], out[f"{prefix}{name}.bias"] = value["scale"], value["bias"]
            elif isinstance(value, dict):
                put(f"{prefix}{name}.", value)
            elif name in ("receptance", "key", "value", "gate", "output", "head", "emb"):
                out[f"{prefix}{name}.weight"] = value
            else:
                out[f"{prefix}{name}"] = value

    top = {k: v for k, v in tree.items() if k != "blocks"}
    put("", top)
    for i, block in enumerate(tree["blocks"]):
        put(f"blocks.{i}.", block)
    return out


def _jax_mlm_loss_fn(p, cfg_, b):
    hidden = jbi.encoder_forward(p, cfg_, b["input_ids"], remat=False)
    return jax_mlm_loss(jax_mlm_logits(p, cfg_, hidden), b["labels"])


def _jax_mae_loss_fn(p, cfg_, b):
    out = jbi.mae_forward(p, cfg_, b["encoder_input_ids"], b["decoder_input_ids"], remat=False)
    loss = jax_mlm_loss(out["encoder_logits"], b["encoder_labels"])
    loss += jax_mlm_loss(out["decoder_logits"], b["decoder_labels"])
    return loss + jbi.dupmae_bow_loss(out["ot_logits"], b["bag_word_weight"])


def _mae_batch(seed):
    return collators.mae_collate(_examples(seed), 16, bag_of_words=True, vocab_size=VOCAB, seed=seed)


def _mlm_batch(seed):
    return collators.mlm_collate(_examples(seed), 16, seed=seed, emb_id=1)


@pytest.mark.parametrize("trainer", ["mlm", "mae"])
def test_loss_grads_and_three_steps_match_jax(trainer):
    """The slice as a whole: every parameter trains, with clip, weight decay
    and layer-wise lr on."""
    mae = trainer == "mae"
    jcfg, params, model = _setup(seed=2, decoder=mae)
    jloss, make_batch = (_jax_mae_loss_fn, _mae_batch) if mae else (_jax_mlm_loss_fn, _mlm_batch)
    loss_fn = (lambda m, b: mae_loss_fn(m, b, remat=True, dup_mae=True)) if mae else (
        lambda m, b: mlm_loss_fn(m, b, remat=True))
    apply_trainable_mask(model, trainable_mask(model, "full"))

    batch = make_batch(10)
    want_loss, want_g = jax.value_and_grad(jloss)(params, jcfg, _jb(batch))
    loss = loss_fn(model, _tb(batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _compare_tree(model, _flat_grads(want_g, jcfg, model.cfg), 1e-4, "grad")
    assert model.head.weight.grad is None and model.emb.weight.grad is not None

    init_fn, step_fn = jax_make_train_step(jcfg, JaxTrainConfig(**STEP_KW), loss_fn=jloss)
    ts = init_fn(params)
    step = make_train_step(model, TrainConfig(**STEP_KW), loss_fn)
    for s in range(3):
        b = make_batch(20 + s)
        ts, jm = step_fn(ts, _jb(b))
        m = step(_tb(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    # Adam divides a gradient by its own running size, so an element whose
    # gradient is 1e-3 of its tensor's largest, known to 1e-6 of that largest,
    # moves by a step known to 1e-3 only. Where 1e-5 of the tensor is less than
    # that (small tensors, and the biases that start at zero and are nothing
    # but their three updates) the bound is 5e-3 of the three steps' lr.
    _compare_tree(model, _flat_grads(ts.params, jcfg, model.cfg), 1e-5, "param",
                  floor=5e-3 * 3 * STEP_KW["lr_init"])


def test_bf16_compute_over_fp32_masters_trains_like_jax():
    jcfg, params, model = _setup(seed=3, dtype="bfloat16", param_dtype="float32")
    jcfg16 = JaxModelConfig(n_layer=2, n_embd=128, vocab_size=VOCAB, head_size=64,
                            dtype="bfloat16", param_dtype="float32")
    batch = _mlm_batch(30)
    want = float(_jax_mlm_loss_fn(params, jcfg16, _jb(batch)))
    loss = mlm_loss_fn(model, _tb(batch), remat=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, rtol=2e-2)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert name == "head.weight" or (p.grad is not None and p.grad.dtype == torch.float32), name
    step = make_train_step(model, TrainConfig(warmup_steps=0), lambda m, b: mlm_loss_fn(m, b))
    losses = [float(step(_tb(batch))["loss"]) for _ in range(4)]
    assert losses[-1] < losses[0]
    assert all(s.dtype == torch.float32 for st in step.optimizer.opt.state.values()
               for s in st.values() if isinstance(s, torch.Tensor))


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A 2-layer bf16 checkpoint with the world vocabulary's size and a jsonl
    of 6 texts (bucket 64, micro-bsz 2: three batches of 2)."""
    tmp = tmp_path_factory.mktemp("mlm_cli")
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=32)
    gen = torch.Generator().manual_seed(0)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    save_rwkv_checkpoint(load_state_dict_into(RWKV(cfg, device="cpu"), sd), str(tmp / "tiny.pth"))
    with open(tmp / "text.jsonl", "w") as f:
        for i in range(6):
            f.write(json.dumps({"text": f"Document {i} about recurrent encoders. " * 2}) + "\n")
    return tmp


def _cli(tmp, command, *extra):
    cmd = [sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli", command, "--platform", "cpu",
           "--model", str(tmp / "tiny.pth"), "--train-data", str(tmp / "text.jsonl"),
           "--micro-bsz", "2", "--max-steps", "2", "--log-every", "1", "--warmup-steps", "0",
           *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("command,extra", [("mlm", []), ("mae", ["--dup-mae"])])
def test_train_cli_mlm_and_mae(tiny_run, command, extra):
    out_dir = tiny_run / f"out_{command}"
    proc = _cli(tiny_run, command, "--output-dir", str(out_dir), *extra)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 1"]
    for ln in lines:
        m = json.loads(ln.split(": ", 1)[1])
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["lr"] > 0
    # rates over what was trained: one step of a (2, 64) bucket batch
    assert m["Kt/s"] == pytest.approx(m["it/s"] * 2 * 64 / 1e3)
    assert (out_dir / "train_log.txt").is_file()
    base = torch.load(str(tiny_run / "tiny.pth"), weights_only=True)
    saved = load_torch_pth(str(out_dir / "encoder-step2.pth"))
    assert sorted(saved) == sorted(base) and not any("onelayer_decoder" in k for k in saved)
    for key, value in saved.items():
        assert value.dtype == np.float32 and value.shape == tuple(base[key].shape), key
    assert np.abs(saved["blocks.0.att.key.weight"]
                  - base["blocks.0.att.key.weight"].float().numpy()).max() > 0
    model, cfg = load_rwkv_checkpoint(str(out_dir / "encoder-step2.pth"), device="cpu")
    assert cfg.n_layer == 2 and model.emb.weight.dtype == torch.bfloat16


# mae --uni is ported (tests/test_torch_contrastive*.py); --chunk-ctx is not
@pytest.mark.parametrize("command,flag", [("mae", ["--chunk-ctx", "64"]), ("mlm", ["--chunk-ctx", "64"]),
                                          ("mlm", ["--dup-mae"]), ("mlm", ["--quant", "int8"])])
def test_train_cli_refuses_unported_encoder_options(tiny_run, command, flag):
    proc = _cli(tiny_run, command, "--output-dir", str(tiny_run / "refused"), *flag)
    assert proc.returncode == 2 and "error" in proc.stderr
