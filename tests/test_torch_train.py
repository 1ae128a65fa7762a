"""The port's SFT training slice (CPU, the kernels' plain versions) against
the JAX package on the same weights, adapter and batches: LoRA and
state-tuning losses, gradients and optimizer steps, the data pipeline, the
adapter files and the trainer CLI.

Tolerances: loss and gradients within 1e-4 of the largest |JAX value| (the
JAX forward runs its chunked WKV factoring, the port the sequential
recurrence, both fp32); parameters after three steps within 1e-5.
"""
import functools
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
from rwkv_lm_ext_tpu.adapters import LoraConfig as JaxLoraConfig
from rwkv_lm_ext_tpu.adapters import apply_lora_unfused
from rwkv_lm_ext_tpu.adapters import init_lora_params as jax_init_lora_params
from rwkv_lm_ext_tpu.adapters.lora import lora_state_dict_to_tree as jax_lora_state_dict_to_tree
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.checkpoint.pth import load_torch_pth
from rwkv_lm_ext_tpu.config import TrainConfig as JaxTrainConfig
from rwkv_lm_ext_tpu.data.buckets import BucketBatchSampler as JaxBucketBatchSampler
from rwkv_lm_ext_tpu.data.buckets import LengthBucketedDataset as JaxDataset
from rwkv_lm_ext_tpu.data.collators import sft_collate as jax_sft_collate
from rwkv_lm_ext_tpu.data.sft import encode_sft_example as jax_encode_sft_example
from rwkv_lm_ext_tpu.data.tokenizer import WorldTokenizer as JaxWorldTokenizer
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.train.losses import causal_lm_loss as jax_causal_lm_loss
from rwkv_lm_ext_tpu.train.loop import make_train_step as jax_make_train_step
from rwkv_lm_ext_tpu.train.loop import sft_loss_fn as jax_sft_loss_fn
from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    apply_lora,
    init_lora_params,
    lora_adapter,
    lora_state_dict,
    lora_state_dict_to_tree,
    merge_lora,
)
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    load_state_dict_into,
    lora_tree_from_jax,
    save_rwkv_checkpoint,
)
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.config import ModelConfig, TrainConfig
from rwkv_lm_ext_tpu_torch.data.buckets import BucketBatchSampler, LengthBucketedDataset
from rwkv_lm_ext_tpu_torch.data.collators import sft_collate
from rwkv_lm_ext_tpu_torch.data.sft import encode_sft_example
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.train.loop import make_train_step, sft_loss_fn

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 1000


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (name, err, np.abs(want).max())


def _jax_setup(seed=0):
    """fp32 2-layer model, n_embd 128, head 64, with the zero-initialised
    projections filled (every block does work), on both sides."""
    jcfg = JaxModelConfig(n_layer=2, n_embd=128, vocab_size=VOCAB, head_size=64,
                          dtype="float32", param_dtype="float32")
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    sd = jax_params_to_state_dict(params, jcfg)
    model = load_state_dict_into(RWKV(sniff_model_config(sd, dtype="float32"), device="cpu"), sd)
    return jcfg, params, model


def _batch(seed, B=2, T=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, VOCAB, size=(B, T)).astype(np.int32)
    labels = np.full_like(ids, -100)
    labels[:, 5:-1] = ids[:, 6:]          # prompt and last position unsupervised
    return {"input_ids": ids, "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jax_adapter(params, lc, seed):
    """JAX init, then B filled from numpy (with B = 0 every dA would be 0)."""
    adapter = jax_init_lora_params(jax.random.PRNGKey(seed), params, lc)
    rng = np.random.default_rng(seed)
    return {k: {"A": ab["A"], "B": jnp.asarray(rng.normal(size=ab["B"].shape) * 0.05, jnp.float32)}
            for k, ab in adapter.items()}


def test_lora_loss_grads_and_steps_match_jax():
    jcfg, params, model = _jax_setup()
    jlc = JaxLoraConfig(r=4, alpha=16.0)
    adapter = _jax_adapter(params, jlc, 1)
    apply_lora(model, LoraConfig(r=4, alpha=16.0), lora_tree_from_jax(adapter))
    assert sorted(n for n, p in model.named_parameters() if p.requires_grad) == sorted(
        f"blocks.{i}.{sub}.{t}.lora_{ab}" for i in range(2)
        for sub, ts in (("att", ("receptance", "key", "value", "gate", "output")),
                        ("ffn", ("key", "value", "receptance")))
        for t in ts for ab in "AB")
    batch = _batch(2)

    def jloss(a, frozen, cfg_, b):
        return jax_sft_loss_fn(apply_lora_unfused(frozen, a, jlc), cfg_, b, remat=False)

    want_loss, want_g = jax.value_and_grad(jloss)(adapter, params, jcfg,
                                                  {k: jnp.asarray(v) for k, v in batch.items()})
    loss = sft_loss_fn(model, _tb(batch), remat=False)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = {n: (m.lora_A.grad, m.lora_B.grad) for n, m in model.named_modules()
           if hasattr(m, "lora_A")}
    assert sorted(got) == sorted(want_g)
    for key, (gA, gB) in got.items():
        _close(gA.numpy(), want_g[key]["A"], 1e-4, key + ".A")
        _close(gB.numpy(), want_g[key]["B"], 1e-4, key + ".B")

    kw = dict(lr_init=1e-3, lr_final=1e-4, warmup_steps=1, total_steps=3, weight_decay=0.01,
              grad_clip=1.0, grad_checkpoint=False)
    init_fn, step_fn = jax_make_train_step(jcfg, JaxTrainConfig(**kw), loss_fn=jloss)
    ts = init_fn(adapter)
    step = make_train_step(model, TrainConfig(**kw))
    for s in range(3):
        b = _batch(10 + s)
        ts, jm = step_fn(ts, {k: jnp.asarray(v) for k, v in b.items()}, params)
        m = step(_tb(b))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for key, ab in lora_adapter(model).items():
        for name in "AB":
            _close(ab[name].numpy(), ts.params[key][name], 1e-5, f"{key}.{name}")


def test_state_tuning_grads_and_steps_match_jax():
    """Non-zero time_state on both sides, grad_clip 0: the JAX states mode
    clips over the whole tree's gradients, the port over time_state only."""
    jcfg, params, model = _jax_setup(seed=3)
    H, N = jcfg.n_head, jcfg.head_size
    rng = np.random.default_rng(4)
    model.requires_grad_(False)
    model.add_state_params()
    for i, bp in enumerate(params["blocks"]):
        ts0 = (rng.normal(size=(H, N, N)) * 0.1).astype(np.float32)
        bp["att"]["time_state"] = jnp.asarray(ts0)
        with torch.no_grad():
            model.blocks[i].att.time_state.copy_(torch.from_numpy(ts0))
    batch = _batch(5)

    def jloss(p, cfg_, b):
        logits, _ = jax_rwkv_forward(p, cfg_, b["input_ids"], use_state_params=True)
        return jax_causal_lm_loss(logits, b["labels"])

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_g = jax.value_and_grad(jloss)(params, jcfg, jb)
    loss = sft_loss_fn(model, _tb(batch), remat=True, use_state_params=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for i, blk in enumerate(model.blocks):
        _close(blk.att.time_state.grad.numpy(), want_g["blocks"][i]["att"]["time_state"], 1e-4,
               f"time_state {i}")

    kw = dict(lr_init=1e-3, lr_final=1e-4, warmup_steps=0, total_steps=3, weight_decay=0.01,
              grad_clip=0.0)
    init_fn, step_fn = jax_make_train_step(jcfg, JaxTrainConfig(grad_checkpoint=False, **kw),
                                           loss_fn=jloss, train_type="states")
    ts = init_fn(params)
    step = make_train_step(model, TrainConfig(grad_checkpoint=True, **kw),
                           functools.partial(sft_loss_fn, remat=True, use_state_params=True))
    for s in range(3):
        b = _batch(20 + s)
        ts, _ = step_fn(ts, {k: jnp.asarray(v) for k, v in b.items()})
        step(_tb(b))
    for i, blk in enumerate(model.blocks):
        _close(blk.att.time_state.detach().numpy(), ts.params["blocks"][i]["att"]["time_state"],
               1e-5, f"time_state {i}")


def test_remat_on_and_off_give_equal_grads():
    _, params, model = _jax_setup(seed=6)
    adapter = lora_tree_from_jax(_jax_adapter(params, JaxLoraConfig(r=4, alpha=16.0), 7))
    apply_lora(model, LoraConfig(r=4, alpha=16.0), adapter)
    grads = []
    for remat in (True, False):
        model.zero_grad()
        sft_loss_fn(model, _tb(_batch(8)), remat=remat).backward()
        grads.append([p.grad.clone() for p in model.parameters() if p.requires_grad])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_merged_adapter_reproduces_the_unfused_forward():
    _, params, model = _jax_setup(seed=9)
    lc = LoraConfig(r=4, alpha=16.0)
    apply_lora(model, lc, lora_tree_from_jax(_jax_adapter(params, JaxLoraConfig(r=4, alpha=16.0), 10)))
    tokens = torch.from_numpy(_batch(11)["input_ids"]).long()
    with torch.no_grad():
        unfused, _ = model(tokens)
        merged, _ = merge_lora(model)(tokens)
    assert not any(hasattr(m, "lora_A") for m in model.modules())
    _close(merged.numpy(), unfused.numpy(), 1e-5)


def test_lora_init_and_the_reference_file_layout(tmp_path):
    cfg = ModelConfig(n_layer=2, n_embd=128, vocab_size=VOCAB, head_size=64, dtype="float32")
    model = load_state_dict_into(
        RWKV(cfg, device="cpu"),
        init_rwkv_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    lc = LoraConfig(r=8, alpha=32.0)
    adapter = init_lora_params(model, lc, torch.Generator().manual_seed(1))
    assert len(adapter) == 16
    for key, ab in adapter.items():
        fan_in = 128 if not key.endswith("ffn.value") else cfg.dim_ffn
        bound = np.sqrt(3.0) * np.sqrt(2.0 / fan_in)
        assert ab["A"].shape == (fan_in, 8) and ab["A"].dtype == torch.float32
        assert float(ab["A"].abs().max()) <= bound and float(ab["A"].abs().max()) > 0.8 * bound
        assert torch.count_nonzero(ab["B"]) == 0 and ab["B"].shape[0] == 8
    rng = np.random.default_rng(2)
    for ab in adapter.values():
        ab["B"] = torch.from_numpy(rng.normal(size=tuple(ab["B"].shape)).astype(np.float32))
    apply_lora(model, lc, adapter)
    path = str(tmp_path / "lora.pth")
    torch.save(lora_state_dict(model), path)
    jtree = jax_lora_state_dict_to_tree(load_torch_pth(path))
    assert sorted(jtree) == sorted(adapter)
    back = lora_state_dict_to_tree(torch.load(path, weights_only=True))
    for key, ab in adapter.items():
        for name in "AB":
            np.testing.assert_array_equal(np.asarray(jtree[key][name]), ab[name].numpy())
            assert torch.equal(back[key][name], ab[name])


def test_data_pipeline_matches_jax():
    tok, jtok = WorldTokenizer(), JaxWorldTokenizer()
    rows = [("Summarise", f"text {i} " * (i * 7 % 40), "out " * (i % 9)) for i in range(40)]
    exs = [encode_sft_example(tok, *row) for row in rows]
    assert exs == [jax_encode_sft_example(jtok, *row) for row in rows]
    ds, jds = LengthBucketedDataset(), JaxDataset()
    for ex in exs:
        assert ds.add(ex, len(ex["input_ids"])) == jds.add(ex, len(ex["input_ids"]))
    sizes = {64: 3, 128: 2, 256: 1}
    order = list(BucketBatchSampler(ds, sizes, seed=5))
    assert order == list(JaxBucketBatchSampler(jds, sizes, seed=5)) and len(order) > 3
    for fixed_len, examples in BucketBatchSampler(ds, sizes, seed=5).batches():
        got, want = sft_collate(examples, fixed_len), jax_sft_collate(examples, fixed_len)
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A 2-layer bf16 checkpoint with the world vocabulary's size and a
    jsonl of 4 rows (bucket 64, two batches of 2)."""
    tmp = tmp_path_factory.mktemp("train_cli")
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=32)
    gen = torch.Generator().manual_seed(0)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        # init zeroes these, which would leave time_state without a gradient
        sd[key] = torch.randn(sd[key].shape, generator=gen) * 0.5 / sd[key].shape[1] ** 0.5
    save_rwkv_checkpoint(load_state_dict_into(RWKV(cfg, device="cpu"), sd), str(tmp / "tiny.pth"))
    with open(tmp / "sft.jsonl", "w") as f:
        for i in range(4):
            f.write(json.dumps({"instruction": "Say hi", "input": f"case {i}",
                                "output": "hi " * (i + 1)}) + "\n")
    return tmp


def _cli(tmp, *extra, command="sft"):
    cmd = [sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli", command, "--platform", "cpu",
           "--model", str(tmp / "tiny.pth"), "--train-data", str(tmp / "sft.jsonl"),
           "--micro-bsz", "2", "--max-steps", "2", "--log-every", "1", "--warmup-steps", "0",
           *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("train_type", ["lora", "states"])
def test_train_cli_sft(tiny_run, train_type):
    out_dir = tiny_run / f"out_{train_type}"
    proc = _cli(tiny_run, "--output-dir", str(out_dir), "--train-type", train_type)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 1"]
    for ln in lines:
        m = json.loads(ln.split(": ", 1)[1])
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["lr"] > 0
    # rates over what was trained: one step of a (2, 64) bucket batch
    assert m["Kt/s"] == pytest.approx(m["it/s"] * 2 * 64 / 1e3)
    assert (out_dir / "train_log.txt").is_file()
    if train_type == "lora":
        sd = load_torch_pth(str(out_dir / "lora-step2.pth"))
        assert len(sd) == 2 * 8 * 2
        assert sd["blocks.0.att.key.lora_A"].shape == (8, 64)
        assert sd["blocks.1.ffn.value.lora_B"].shape == (64, 8)
    else:
        sd = load_torch_pth(str(out_dir / "states-step2.pth"))
        assert sorted(sd) == ["blocks.0.att.time_state", "blocks.1.att.time_state"]
        assert sd["blocks.0.att.time_state"].shape == (2, 32, 32)
        assert np.abs(sd["blocks.1.att.time_state"]).max() > 0


# TPU layout workarounds (ROADMAP "Not to port") and the multi-process
# combinations that are not ported (A.12): tp under a trainer whose loss
# couples the rows, pp beside a train type but full
@pytest.mark.parametrize("flag", [["--stack-layers"], ["--bwd-transpose"],
                                  ["bi-encoder", "--tp", "2"], ["--pp", "2"]])
def test_train_cli_refuses_unported_options(tiny_run, flag):
    command = flag.pop(0) if not flag[0].startswith("--") else "sft"
    proc = _cli(tiny_run, "--output-dir", str(tiny_run / "refused"), *flag, command=command)
    assert proc.returncode == 2 and "error" in proc.stderr
