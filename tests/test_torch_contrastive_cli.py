"""The port's contrastive and reranking trainers against the JAX package's
commands, and the trainer CLI end to end (CPU, the kernels' plain
versions).

The parity tests (the shared harness of tests/torch_stack_setup.py,
``TRAINER_DOC``) hold the LoRA trainers and the causal model's
full-parameter ones (bi-encoder, cross-encoder, nli, simcse, instructor)
against the JAX commands; tests/test_torch_contrastive.py holds the encoder
ones. The CLI tests run every new command on a tiny checkpoint and read the
files it writes with the JAX package's reader.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.checkpoint.pth import load_torch_pth
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into, save_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.train import cli as pcli
from torch_stack_setup import TRAINER_CASES, check_trainer_against_jax, contrastive_data

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return contrastive_data(tmp_path_factory.mktemp("contrastive_data"))


CAUSAL = [c for c in TRAINER_CASES if c[0] in ("bi-encoder", "cross-encoder", "nli", "simcse",
                                                "instructor")]


@pytest.mark.parametrize("command,fmt,extra", CAUSAL, ids=[" ".join([c] + e) for c, _, e in CAUSAL])
def test_trainer_matches_the_jax_command(data, tmp_path, command, fmt, extra):
    check_trainer_against_jax(data, tmp_path, command, fmt, extra)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A 2-layer bf16 checkpoint with the world vocabulary's size."""
    tmp = tmp_path_factory.mktemp("contrastive_cli")
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=32)
    gen = torch.Generator().manual_seed(0)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen) * 0.5 / sd[key].shape[1] ** 0.5
    path = tmp / "tiny.pth"
    save_rwkv_checkpoint(load_state_dict_into(RWKV(cfg, device="cpu"), sd), str(path))
    return path, sorted(sd)


LORA_KEYS = 2 * 8 * 2
# command, data, extra flags, {file: check}
CLI_RUNS = [
    ("bi-encoder", "triplet", [], {"bi-encoder-step2.pth": "lora"}),
    ("cross-encoder", "pair", [], {"cross-encoder-step2.pth": "lora", "score-step2.pth": "score"}),
    ("nli", "nli", ["--sts-file", "sts", "--max-seq-len", "64"], {"nli-step2.pth": "base"}),
    ("simcse", "simcse", [], {"simcse-step2.pth": "base"}),
    ("instructor", "instructor", ["--output-dim", "48"], {"instructor-step2.pth": "instructor"}),
    ("encoder-biencoder", "triplet", [], {"encoder-bi-step2.pth": "base"}),
    ("encoder-crossencoder", "documents", ["--group-size", "2"],
     {"encoder-cross-step2.pth": "score+base"}),
    ("mae", "text", ["--uni", "--dup-mae"], {"encoder-step2.pth": "base"}),
]


@pytest.mark.parametrize("command,fmt,extra,files", CLI_RUNS, ids=[r[0] for r in CLI_RUNS])
def test_train_cli_writes_the_jax_files(tiny, data, tmp_path, capsys, command, fmt, extra, files):
    path, base_keys = tiny
    extra = [data["sts"] if x == "sts" else x for x in extra]
    pcli.main([command, *extra, "--platform", "cpu", "--model", str(path), "--train-data",
               data[fmt], "--output-dir", str(tmp_path), "--micro-bsz", "2", "--max-steps", "2",
               "--log-every", "1", "--warmup-steps", "0", "--ctx-len", "64"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 0", "step 1"]
    for ln in lines:
        m = json.loads(ln.split(": ", 1)[1])
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) and m["lr"] > 0
    assert (tmp_path / "train_log.txt").is_file()
    for name, kind in files.items():
        sd = load_torch_pth(str(tmp_path / name))       # the JAX package's reader
        assert all(v.dtype == np.float32 for v in sd.values()), name
        if kind == "lora":
            assert len(sd) == LORA_KEYS
            assert sd["blocks.0.att.key.lora_A"].shape == (8, 64)
            assert sd["blocks.1.ffn.value.lora_B"].shape == (64, 8)
        elif kind == "score":
            assert list(sd) == ["score.weight"] and sd["score.weight"].shape == (1, 64)
        else:
            heads = {"base": [], "score+base": ["score.weight"],
                     "instructor": ["dense.bias", "dense.weight", "ln_dense.bias",
                                    "ln_dense.weight"]}[kind]
            assert sorted(sd) == sorted(base_keys + heads)
            if kind == "instructor":
                assert sd["dense.weight"].shape == (48, 64) and sd["ln_dense.bias"].shape == (48,)
            if kind == "score+base":
                assert sd["score.weight"].shape == (1, 64)
    if command == "nli":
        csv = tmp_path / "similarity_evaluation_sts-dev_results.csv"
        rows = csv.read_text().splitlines()
        assert rows[0].startswith("epoch,steps,cosine_pearson") and len(rows) == 2


def test_cross_encoder_through_python_dash_m(tiny, data, tmp_path):
    path, _ = tiny
    cmd = [sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli", "cross-encoder", "--platform",
           "cpu", "--model", str(path), "--train-data", data["pair"], "--output-dir",
           str(tmp_path), "--micro-bsz", "2", "--max-steps", "1", "--ctx-len", "64"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "score-step1.pth").is_file()


@pytest.mark.parametrize("argv", [["bi-encoder", "--quant", "int8"],
                                  ["cross-encoder", "--quant", "int8c"],
                                  ["simcse", "--chunk-ctx", "64"]])
def test_unported_options_are_refused(tiny, data, tmp_path, capsys, argv):
    """By argparse (exit 2): ``--quant`` under the LoRA rerankers (ROADMAP
    C.19) and ``--chunk-ctx`` outside ``sft``. (``simcse --dropout-noise``,
    refused here until the model had dropout, trains:
    tests/test_torch_dropout.py.)"""
    path, _ = tiny
    with pytest.raises(SystemExit) as e:
        pcli.main(argv + ["--platform", "cpu", "--model", str(path), "--train-data",
                          data["simcse" if argv[0] == "simcse" else "pair"], "--output-dir",
                          str(tmp_path)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert argv[1] in err
    assert not list(tmp_path.iterdir())
