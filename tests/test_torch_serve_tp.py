"""``python -m rwkv_lm_ext_tpu_torch.serve.cli --tp 2 --batcher-slots 2
--platform cpu`` over HTTP: rank 0 starts rank 1 itself (a file rendezvous),
/generate gives the single-process CLI's greedy tokens, blocking and streamed,
/embed unit-norm embeddings equal to the single-process CLI's, /stats the
route (tp 2 over gloo, eager blocks), a 200 KB request gets 400 and the next
one is answered; SIGTERM stops both processes. Each flag whose backend is not
ported under --tp is refused by name before any process starts. The
single-process CLI's answers come from its ``build_service`` in this process
(tests/test_torch_serve_stack.py holds that CLI against the JAX one)."""
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    apply_lora,
    init_lora_params,
    lora_state_dict,
)
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into, save_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.serve import cli

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = Path(__file__).resolve().parent.parent
GREEDY = {"max_tokens": 8, "temperature": 0.0, "token_stop": []}
PROMPTS = ["Hello world", "RWKV is an RNN with transformer-level performance."]
TEXTS = ["a b c", "数据 and text"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_tp")
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=16, dtype="float32")
    gen = torch.Generator().manual_seed(11)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen) * (0.5 / sd[key].shape[1] ** 0.5)
    model = load_state_dict_into(RWKV(cfg, device="cpu"), sd)
    save_rwkv_checkpoint(model, str(d / "m.pth"))
    lc = LoraConfig(r=4, alpha=8.0)
    adapter = init_lora_params(model, lc, gen)
    for ab in adapter.values():
        ab["B"] = torch.randn(ab["B"].shape, generator=gen) * 0.05
    torch.save(lora_state_dict(apply_lora(model, lc, adapter)), d / "bi.pth")
    return d


def _args(files, *extra):
    return ["--model", str(files / "m.pth"), "--bi-adapter", str(files / "bi.pth"),
            "--lora-r", "4", "--lora-alpha", "8", "--platform", "cpu", "--dtype", "float32",
            "--batcher-slots", "2", "--port", "0", *extra]


def _post(base, route, payload):
    data = json.dumps(payload).encode()
    req = urllib.request.Request(base + route, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            if resp.headers.get("Content-Type", "").startswith("text/event-stream"):
                return resp.status, [json.loads(e[6:]) for e in body.split(b"\n\n") if e]
            return resp.status, json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _live(marker: str) -> list:
    """Processes whose command line holds ``marker``."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if marker.encode() in f.read():
                    found.append(int(pid))
        except OSError:
            pass
    return found


@pytest.fixture(scope="module")
def server(files):
    """Rank 0 of `serve.cli --tp 2` as a subprocess, started (it loads while
    `single` runs); stopped with SIGTERM at the end."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-m", "rwkv_lm_ext_tpu_torch.serve.cli",
                             *_args(files, "--tp", "2")], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, text=True)
    yield proc
    proc.terminate()
    proc.wait(timeout=90)


@pytest.fixture(scope="module")
def single(server, files):
    """The single-process CLI's answers (its service, in this process)."""
    svc = cli.build_service(cli.parse_args(_args(files)))
    svc.warmup()
    try:
        return {"generate": [svc.handle("/generate", {"prompt": p, **GREEDY})["output"]
                             for p in PROMPTS],
                "embed": svc.handle("/embed", {"texts": TEXTS})["embeddings"]}
    finally:
        svc.close()


@pytest.fixture(scope="module")
def served(server, single):
    """(base URL, the lines before it, the process) once rank 0 serves."""
    lines, base = [], None
    timer = threading.Timer(120, server.kill)
    timer.start()
    try:
        for line in server.stdout:
            lines.append(line)
            if line.startswith("serving on "):
                base = line.split()[-1]
                break
    finally:
        timer.cancel()
    assert base is not None, "".join(lines)
    return base, lines, server


def test_generate_matches_the_single_process_cli(served, single):
    base, _, _ = served
    for prompt, want in zip(PROMPTS, single["generate"]):
        code, body = _post(base, "/generate", {"prompt": prompt, **GREEDY})
        assert code == 200 and body == {"output": want, "backend": "batcher"}
    code, events = _post(base, "/generate", {"prompt": PROMPTS[0], "stream": True, **GREEDY})
    assert code == 200 and events[-1]["done"] and events[-1]["output"] == single["generate"][0]
    assert "".join(e["token"] for e in events[:-1]) == single["generate"][0]


def test_embed_gives_unit_norms(served, single):
    base, _, _ = served
    code, body = _post(base, "/embed", {"texts": TEXTS})
    assert code == 200
    emb = np.asarray(body["embeddings"])
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(emb, single["embed"], rtol=0, atol=1e-5)


def test_stats_show_the_route_and_an_oversized_request_fails_alone(served):
    base, lines, _ = served
    route = {"device": "cpu", "blocks": "eager", "tp": 2, "rank": 0, "backend": "gloo"}
    assert any(line == f"route: {json.dumps(route)}\n" for line in lines)
    for payload, route_name in (({"texts": ["x" * 200_000]}, "/embed"),
                                ({"prompt": "x" * 200_000, **GREEDY}, "/generate")):
        code, body = _post(base, route_name, payload)
        assert code == 400 and "bytes" in body["error"]
    code, body = _post(base, "/similarity", {"texts_a": ["a"], "texts_b": ["a"]})
    assert code == 200 and abs(body["similarity"][0][0] - 1.0) < 1e-5
    code, stats = _post(base, "/stats", {})
    assert code == 200 and stats["route"] == route


def test_sigterm_stops_every_rank(files, served):
    _, _, proc = served
    proc.terminate()
    proc.wait(timeout=90)
    assert not _live(str(files / "m.pth"))


@pytest.mark.parametrize("flag", cli.TP_REFUSED)
def test_unported_flags_are_refused_by_name(files, flag):
    value = {"--draft-layers": "1", "--prefix-cache": "4"}.get(flag, "x.pth")
    with pytest.raises(SystemExit, match=flag):
        cli.main(_args(files, "--tp", "2", flag, value))
