"""The ``sft`` train types, QLoRA modes and options end to end through the
trainer CLI on the CPU (``main`` in this process, one world tokenizer for
all; train-state resume as ``python -m rwkv_lm_ext_tpu_torch.train.cli``
subprocesses): a 2-layer bf16 checkpoint with the world vocabulary's size,
two steps a run, the files each writes read with the JAX package's reader;
and ``serve.cli --pissa-init``. Their parity with the JAX commands is held in
tests/test_torch_peft.py, test_torch_qlora.py and test_torch_tbptt.py.

Tolerances: a resumed run's step equals the uninterrupted run's bit for
bit; the served PiSSA weights equal ``merge_pissa``'s within 1e-6.
"""
import copy
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.checkpoint.pth import load_torch_pth
from rwkv_lm_ext_tpu.adapters.lora import lora_state_dict_to_tree as jax_lora_state_dict_to_tree
from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    adapter_state_dict,
    lora_state_dict_to_tree,
    merge_pissa,
    pissa_init,
)
from rwkv_lm_ext_tpu_torch.adapters.quant import MODES
from rwkv_lm_ext_tpu_torch.adapters.slot_lora import build_slot_lora
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into, save_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.serve import cli as serve_cli
from rwkv_lm_ext_tpu_torch.train import cli as pcli
from torch_stack_setup import _tokenizer, sft_data

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A 2-layer bf16 checkpoint with the world vocabulary's size, an SFT
    jsonl of 8 rows (bucket 64) and one with two tasks."""
    tmp = tmp_path_factory.mktemp("peft_cli")
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=32)
    gen = torch.Generator().manual_seed(0)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen) * 0.5 / sd[key].shape[1] ** 0.5
    save_rwkv_checkpoint(load_state_dict_into(RWKV(cfg, device="cpu"), sd), str(tmp / "tiny.pth"))
    sft_data(tmp)
    sft_data(tmp, tasks=["chat", "kg"])
    return tmp


@pytest.fixture
def cli(capsys):
    """run(tmp, out, *extra, data=...): ``train.cli main(["sft", ...])`` for
    2 steps on the tiny checkpoint, the world tokenizer loaded once; its two
    logged losses must be finite."""
    def run(tmp, out, *extra, data="sft.jsonl"):
        argv = ["sft", "--platform", "cpu", "--model", str(tmp / "tiny.pth"), "--train-data",
                str(tmp / data), "--output-dir", str(out), "--micro-bsz", "2", "--max-steps", "2",
                "--log-every", "1", "--warmup-steps", "0", *extra]
        capsys.readouterr()
        with mock.patch.object(pcli, "WorldTokenizer", _tokenizer(pcli.WorldTokenizer)):
            pcli.main(argv)
        stdout = capsys.readouterr().out
        losses = [json.loads(ln.split(": ", 1)[1])["loss"] for ln in stdout.splitlines()
                  if ln.startswith("step ")]
        assert len(losses) == 2 and np.isfinite(losses).all(), stdout

    return run


def test_train_cli_full(tiny, cli):
    out = tiny / "full"
    cli(tiny, out, "--train-type", "full")
    base, sd = torch.load(tiny / "tiny.pth", weights_only=True), load_torch_pth(str(out / "model-step2.pth"))
    assert sorted(sd) == sorted(base) and all(v.dtype == np.float32 for v in sd.values())
    assert np.abs(sd["blocks.1.att.key.weight"] - base["blocks.1.att.key.weight"].float().numpy()).max() > 0


def test_train_cli_pissa_writes_init_pissa(tiny, cli):
    out = tiny / "pissa"
    cli(tiny, out, "--train-type", "pissa", "--lora-r", "4")
    init = load_torch_pth(str(out / "init_pissa.pth"))
    trained = load_torch_pth(str(out / "lora-step2.pth"))
    assert sorted(init) == sorted(trained) and len(init) == 2 * 8 * 2
    assert init["blocks.0.att.key.lora_A"].shape == (4, 64) and init["blocks.0.ffn.value.lora_B"].shape == (64, 4)
    assert sorted(jax_lora_state_dict_to_tree(init)) == sorted(lora_state_dict_to_tree(init))
    assert any(np.abs(init[k] - trained[k]).max() > 0 for k in init)


def test_train_cli_slot_lora(tiny, cli):
    """Per-task files under the JAX names, two different adapters that the
    slot-LoRA server takes; a row without a task exits with JAX's message."""
    out = tiny / "slot"
    cli(tiny, out, "--train-type", "slot-lora", "--lora-r", "4", data="sft_tasks.jsonl")
    named = {t: lora_state_dict_to_tree(torch.load(out / f"lora-{t}-step2.pth", weights_only=True))
             for t in ("chat", "kg")}
    a = torch.cat([v["B"].flatten() for v in named["chat"].values()])
    b = torch.cat([v["B"].flatten() for v in named["kg"].values()])
    assert a.abs().max() > 0 and b.abs().max() > 0 and not torch.allclose(a, b)
    model, _ = pcli.load_rwkv_checkpoint(str(tiny / "tiny.pth"), device="cpu")
    _, ids = build_slot_lora(model, named, LoraConfig(r=4, alpha=32.0))
    assert set(ids) == {"base", "chat", "kg"}
    with pytest.raises(SystemExit, match="needs a 'task' field on every training row"):
        cli(tiny, out / "no_task", "--train-type", "slot-lora")


@pytest.mark.parametrize("extra", [
    ["--train-type", "lora", "--lora-apply", "merge"],
    ["--train-type", "full", "--lisa-k", "1", "--lisa-interval", "1"],
    ["--train-type", "lora", "--grad-checkpoint", "dots"],
    ["--train-type", "lora", "--grad-checkpoint", "dots_nobatch"],
], ids=lambda e: " ".join(e))
def test_train_cli_options(tiny, cli, extra):
    out = tiny / "_".join(a.strip("-") for a in extra)
    cli(tiny, out, *extra)
    name = "model-step2.pth" if "full" in extra else "lora-step2.pth"
    assert (out / name).is_file() and (out / "train_log.txt").is_file()


def test_train_state_resume_is_bit_exact(tiny):
    """Save the train state after step 2, resume from it at step 2, and the
    step-3 adapter equals the uninterrupted run's, bit for bit; the upload
    command runs after the save, {dir} the output directory."""
    common = ["--train-type", "lora", "--warmup-steps", "1", "--lr-init", "1e-3"]
    straight, first, resumed = tiny / "straight", tiny / "first", tiny / "resumed"
    _cli3 = ["--max-steps", "3"]
    cmd = [sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli", "sft", "--platform", "cpu",
           "--model", str(tiny / "tiny.pth"), "--train-data", str(tiny / "sft.jsonl"),
           "--micro-bsz", "2", "--log-every", "1", *common]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    upload = ["--upload-cmd", "ls {dir} > {dir}/uploaded.txt"]
    for out, extra in ((straight, _cli3), (first, ["--max-steps", "2", "--save-train-state", *upload]),
                       (resumed, _cli3 + ["--resume-train-state", str(first / "train_state.pth"),
                                          "--skip-steps", "2"])):
        proc = subprocess.run(cmd + ["--output-dir", str(out), *extra], cwd=REPO,
                              capture_output=True, text=True, timeout=300, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "train_state.pth" in (first / "uploaded.txt").read_text().split()
    state = torch.load(first / "train_state.pth", weights_only=True)
    assert state["count"] == 2 and len(state["params"]) == 2 * 8 * 2
    want = torch.load(straight / "lora-step3.pth", weights_only=True)
    got = torch.load(resumed / "lora-step3.pth", weights_only=True)
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not all(torch.equal(got[k], torch.load(first / "lora-step2.pth", weights_only=True)[k])
                   for k in want)


def test_serve_cli_pissa_init(tmp_path):
    """serve.cli --chat-adapter with --pissa-init serves W + A @ B - A_init
    @ B_init (merge_pissa over the checkpoint's weights), and quantizes
    after that under --quant nf4."""
    cfg = ModelConfig(n_layer=2, n_embd=128, vocab_size=65536, head_size=64, dtype="float32")
    model = load_state_dict_into(RWKV(cfg, device="cpu"), init_rwkv_params(
        cfg, generator=torch.Generator().manual_seed(9), device="cpu"))
    path = str(tmp_path / "m.pth")
    save_rwkv_checkpoint(model, path)
    lc = LoraConfig(r=4, alpha=16.0, pissa=True)
    init, _ = pissa_init(copy.deepcopy(model), lc, torch.Generator().manual_seed(0))
    trained = {k: {"A": ab["A"] * 1.1, "B": ab["B"] + 0.01} for k, ab in init.items()}
    torch.save(adapter_state_dict(init), tmp_path / "init_pissa.pth")
    torch.save(adapter_state_dict(trained), tmp_path / "lora.pth")
    want = merge_pissa(copy.deepcopy(model), trained, init, lc)
    common = ["--model", path, "--platform", "cpu", "--dtype", "float32", "--lora-r", "4",
              "--lora-alpha", "16", "--chat-adapter", str(tmp_path / "lora.pth"),
              "--pissa-init", str(tmp_path / "init_pissa.pth")]
    service = serve_cli.build_service(serve_cli.parse_args(common))
    got = service.engine.model.state_dict()
    for key, value in want.state_dict().items():
        torch.testing.assert_close(got[key], value, rtol=0, atol=1e-6)
    service.close()
    service = serve_cli.build_service(serve_cli.parse_args(common + ["--quant", "nf4"]))
    assert service.engine.model.blocks[0].att.key.mode == "nf4"
    service.close()
    with pytest.raises(SystemExit, match="needs --chat-adapter"):
        serve_cli.build_service(serve_cli.parse_args(["--model", path, "--platform", "cpu",
                                                      "--pissa-init", str(tmp_path / "lora.pth")]))


@pytest.mark.parametrize("mode", MODES)
def test_train_cli_qlora(tiny, cli, mode):
    """sft --quant MODE end to end: two steps, lora-step2.pth in the
    reference layout, readable by the JAX package, every B trained."""
    out = tiny / f"out_{mode}"
    cli(tiny, out, "--quant", mode)
    sd = load_torch_pth(str(out / "lora-step2.pth"))
    assert len(sd) == 2 * 8 * 2 and sd["blocks.0.att.key.lora_A"].shape == (8, 64)
    assert all(np.abs(v).max() > 0 for k, v in sd.items() if k.endswith("lora_B"))
