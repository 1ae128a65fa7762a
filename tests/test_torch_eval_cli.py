"""The port's ``python -m rwkv_lm_ext_tpu_torch.eval.cli`` against the JAX
package's ``rwkv_lm_ext_tpu.eval.cli`` on the same files (CPU, the kernels'
plain versions): ``sts``, ``retrieval``, ``rerank``, ``retrieval-task``
(with and without ``--score-head``), ``ppl`` and ``parity``.

Both CLIs load the same ``.pth``: a JAX model (2 layers, n_embd 64, head
size 16, the world vocabulary's 65536 rows, seeded projections) written by
the JAX package's ``save_torch_pth``, with a seeded score head and LoRA
adapter beside it. Each JAX command runs once a module (``jax_out``). For
every command but ``parity`` both loaders are told fp32 compute (the
checkpoint's default is bf16, which the two packages round at other
points): STS Spearman within 1e-6 (Pearson 1e-5), the retrieval and rerank
metrics equal, ``ppl``'s nll_per_token within 1e-5 relative and its token
count equal. ``parity`` runs as a user runs it: its fast side is each
package's bf16 route, which rounds at other points, so the drifts are not
compared with each other: each report's ``pass`` says whether its drift is
within the 1e-3 target, and the port's passes on this model (at this width
the bf16 drift of either package moves with the seed: over six seeded
models JAX read 4.5e-4 to 2.5e-2, the port 2.6e-4 to 1.1e-3; the target is
the full-width acceptance). The fp32 side (``scores_gold``) is equal, and
the gold embeddings (the port's ``BiEncoder(reference=True)``, JAX's
``wkv_backend="reference"``) within 1e-5 of max.
"""
import contextlib
import io
import json
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rwkv_lm_ext_tpu.checkpoint as jcheckpoint
from rwkv_lm_ext_tpu.adapters import LoraConfig as JaxLoraConfig
from rwkv_lm_ext_tpu.adapters import init_lora_params as jax_init_lora_params
from rwkv_lm_ext_tpu.adapters import lora_tree_to_state_dict
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.checkpoint.pth import save_torch_pth
from rwkv_lm_ext_tpu.eval import cli as jax_eval_cli
from rwkv_lm_ext_tpu.infer import encoders as jenc
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.eval import cli
from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder
from rwkv_lm_ext_tpu_torch.utils.device import resolve_device
from torch_stack_setup import jax_params

torch.set_num_threads(1)  # tier-1 runs several pytest workers

TASK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "mini_task")
STS = [("The cat sits on the mat.", "A cat is sitting on a mat.", 4.8),
       ("The cat sits on the mat.", "Stock markets fell sharply today.", 0.2),
       ("北京是中国的首都。", "中国的首都是北京。", 4.9),
       ("北京是中国的首都。", "今天下雨了。", 0.5),
       ("RWKV is a recurrent model.", "RWKV is an RNN with transformer performance.", 3.9),
       ("A man plays the guitar.", "Someone is playing an instrument.", 3.2),
       ("A man plays the guitar.", "The weather is cold in winter.", 0.1),
       ("Bananas are yellow 🍌.", "Bananas are rich in potassium.", 2.5)]
RERANK = [{"query": "capital of France",
           "documents": ["Paris is the capital of France.", "Bananas are yellow.",
                         "France borders Spain.", "北京是中国的首都。"],
           "labels": [1, 0, 0, 0]},
          {"query": "recurrent language models",
           "documents": ["RWKV is a recurrent language model.", "Beam search keeps n hypotheses.",
                         "A tokenizer matches the longest entry."],
           "labels": [1, 0, 1]},
          {"query": "红烧肉怎么做",
           "documents": ["台风登陆前会有强降雨。", "红烧肉需要先焯水，再炒糖色。"],
           "labels": [0, 1]}]
SCORED = [{"scores": [0.1, 0.9, 0.3], "labels": [0, 1, 0]},
          {"scores": [0.5, 0.2, 0.7, 0.1], "labels": [1, 0, 0, 1]}]
PPL = ["RWKV combines the parallel training of transformers with the inference of an RNN; "
       "its state is a fixed size, whatever the context length.",
       "北京是中华人民共和国的首都，也是全国的政治和文化中心。", "short"]


def _jsonl(path, rows):
    with open(path, "w", encoding="utf-8") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The checkpoint, score head, LoRA adapter and data files both CLIs
    read, and the JAX (params, cfg) they hold."""
    d = tmp_path_factory.mktemp("eval_cli")
    params, cfg = jax_params(seed=41, n_layer=2, n_embd=64, vocab_size=65536, head_size=16)
    model = str(d / "m.pth")
    save_torch_pth(model, jax_params_to_state_dict(params, cfg))
    head = str(d / "score.pth")
    w = np.random.default_rng(42).standard_normal((1, cfg.n_embd)).astype(np.float32)
    save_torch_pth(head, {"score.weight": w})
    jlc = JaxLoraConfig(r=4, alpha=8.0)
    adapter = jax_init_lora_params(jax.random.PRNGKey(43), params, jlc)
    rng = np.random.default_rng(43)
    adapter = {k: {"A": ab["A"], "B": jnp.asarray(rng.normal(size=ab["B"].shape) * 0.1,
                                                    jnp.float32)}
               for k, ab in adapter.items()}
    lora = str(d / "lora.pth")
    save_torch_pth(lora, lora_tree_to_state_dict(adapter, jlc))
    queries = [json.loads(line)["text"] for line in open(os.path.join(TASK_DIR, "queries.jsonl"))]
    corpus = [json.loads(line)["text"] for line in open(os.path.join(TASK_DIR, "corpus.jsonl"))]
    qrels = d / "qrels.tsv"
    qrels.write_text("".join(f"{q}\t{dq}\n" for q, dq in ((0, 0), (1, 5), (2, 2), (3, 4),
                                                           (4, 1), (4, 3), (5, 6))))
    return {
        "params": params, "cfg": cfg, "model": model, "score": head,
        "lora": ["--lora", lora, "--lora-r", "4", "--lora-alpha", "8"],
        "sts": _jsonl(d / "sts.jsonl", [{"sentence1": a, "sentence2": b, "score": s}
                                        for a, b, s in STS]),
        "queries": _jsonl(d / "queries.jsonl", [{"text": t} for t in queries]),
        "corpus": _jsonl(d / "corpus.jsonl", [{"text": t} for t in corpus]),
        "qrels": str(qrels),
        "rerank": _jsonl(d / "rerank.jsonl", RERANK),
        "scored": _jsonl(d / "scored.jsonl", SCORED),
        "mixed": _jsonl(d / "mixed.jsonl", SCORED[:1] + RERANK[:1]),
        "ppl": _jsonl(d / "ppl.jsonl", [{"text": t} for t in PPL]),
    }


def _argv(files, name):
    """The argv of command `name` (both CLIs take the same flags)."""
    m = ["--model", files["model"], "--batch-size", "4"]
    return {
        "sts": ["sts", *m, "--data", files["sts"]],
        "sts_lora": ["sts", *m, "--data", files["sts"], *files["lora"]],
        "retrieval": ["retrieval", *m, "--queries", files["queries"], "--corpus", files["corpus"],
                      "--qrels", files["qrels"]],
        "retrieval_task": ["retrieval-task", *m, "--task-dir", TASK_DIR],
        "retrieval_task_rerank": ["retrieval-task", *m, "--task-dir", TASK_DIR, "--score-head",
                                  files["score"], "--rerank-top-k", "5"],
        "rerank": ["rerank", *m, "--data", files["rerank"], "--score-head", files["score"]],
        "rerank_scored": ["rerank", *m, "--data", files["scored"]],
        "ppl": ["ppl", *m, "--data", files["ppl"], "--ctx-len", "16"],
        "parity": ["parity", *m, "--task-dir", TASK_DIR, "--max-texts", "12"],
    }[name]


def _fp32(load):
    """A checkpoint loader that computes in fp32 unless told a dtype."""
    def loader(path, **kw):
        kw.setdefault("dtype", "float32")
        kw.setdefault("param_dtype", "float32")
        return load(path, **kw)
    return loader


def _stdout_json(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return json.loads(buf.getvalue())


def run_jax(files, name):
    if name == "parity":
        return _stdout_json(jax_eval_cli.main, _argv(files, name))
    with mock.patch.object(jcheckpoint, "load_rwkv_checkpoint",
                           _fp32(jcheckpoint.load_rwkv_checkpoint)):
        return _stdout_json(jax_eval_cli.main, _argv(files, name))


def run_port(files, name):
    argv = _argv(files, name) + ["--platform", "cpu"]
    if name == "parity":
        return _stdout_json(cli.main, argv)
    with mock.patch.object(cli, "load_rwkv_checkpoint", _fp32(load_rwkv_checkpoint)):
        return _stdout_json(cli.main, argv)


@pytest.fixture(scope="module")
def jax_out():
    """Each JAX command's output, computed once."""
    cache = {}

    def get(files, name):
        if name not in cache:
            cache[name] = run_jax(files, name)
        return cache[name]

    return get


@pytest.mark.parametrize("name", ["sts", "sts_lora"])
def test_sts_matches_jax(files, jax_out, name):
    want, got = jax_out(files, name), run_port(files, name)
    assert set(got) == set(want) and len(got) == 8
    for key in want:
        tol = 1e-6 if key.endswith("spearman") else 1e-5
        assert abs(got[key] - want[key]) <= tol, (key, got[key], want[key])


@pytest.mark.parametrize("name", ["retrieval", "retrieval_task", "retrieval_task_rerank",
                                  "rerank", "rerank_scored"])
def test_metrics_equal_jax(files, jax_out, name):
    want, got = jax_out(files, name), run_port(files, name)
    assert got == want


def test_ppl_matches_jax(files, jax_out):
    want, got = jax_out(files, "ppl"), run_port(files, "ppl")
    assert got["tokens"] == want["tokens"] > 16      # pieces padded and masked
    assert abs(got["nll_per_token"] - want["nll_per_token"]) <= 1e-5 * want["nll_per_token"]
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=2e-4)


def test_parity_matches_jax(files, jax_out):
    want, got = jax_out(files, "parity"), run_port(files, "parity")
    assert set(got) == set(want)
    assert got["target"] == want["target"] == 1e-3
    for out in (got, want):
        assert out["pass"] == (out["cosine_drift_max"] <= 1e-3)
    # the port's bf16 route on this model: 3.5e-4 (JAX's bf16 route: 7.5e-3)
    assert got["pass"]
    assert got["n_texts"] == want["n_texts"] == 12
    assert got["scores_gold"] == want["scores_gold"]
    assert set(got["score_delta"]) == set(want["score_delta"])
    assert got["reference_wkv_op"] == want["reference_wkv_op"] == {
        "skipped": "reference repo not mounted"}
    # the gold embeddings themselves
    texts = [json.loads(line)["text"] for line in open(os.path.join(TASK_DIR, "queries.jsonl"))]
    tok = WorldTokenizer()
    jparams, jcfg = jcheckpoint.load_rwkv_checkpoint(files["model"], dtype="float32",
                                                     param_dtype="float32")
    want_emb = jenc.BiEncoder(jparams, jcfg, tok, wkv_backend="reference").encode_texts(texts)
    model, _ = load_rwkv_checkpoint(files["model"], device="cpu", dtype="float32",
                                    param_dtype="float32")
    got_emb = BiEncoder(model, tok, reference=True).encode_texts(texts)
    assert np.abs(got_emb - want_emb).max() <= 1e-5 * np.abs(want_emb).max()


def test_rerank_refuses_a_mixed_file_where_jax_raises_keyerror(files):
    """ROADMAP C.23: a file of {"scores"} rows and {"query", "documents"}
    rows stops the JAX CLI with a KeyError on the first scores row it tries
    to score; the port refuses the file by name before loading anything."""
    argv = ["rerank", "--model", files["model"], "--data", files["mixed"], "--score-head",
            files["score"]]
    with pytest.raises(KeyError, match="documents"), contextlib.redirect_stdout(io.StringIO()):
        jax_eval_cli.main(argv)
    with mock.patch.object(cli, "load_rwkv_checkpoint") as load, \
            pytest.raises(SystemExit, match="mixes rows"):
        cli.main(argv + ["--platform", "cpu"])
    load.assert_not_called()
    with pytest.raises(SystemExit, match="--score-head required"):
        cli.main(["rerank", "--model", files["model"], "--data", files["rerank"], "--platform",
                  "cpu"])


@pytest.mark.parametrize("name", ["sts", "ppl", "parity", "retrieval_task"])
def test_platform_defaults_to_cuda_and_exits_without_it(files, name):
    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
            mock.patch.object(cli, "load_rwkv_checkpoint") as load, \
            pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(_argv(files, name))
    load.assert_not_called()


@pytest.mark.parametrize("available", [True, False])
def test_resolve_device(available):
    """The one --platform rule of eval.cli, serve.cli and apps.rag: cpu
    always, cuda only where a CUDA device is present."""
    with mock.patch.object(torch.cuda, "is_available", return_value=available):
        assert resolve_device("cpu") == torch.device("cpu")
        if available:
            assert resolve_device("cuda") == torch.device("cuda")
        else:
            with pytest.raises(SystemExit, match="no CUDA device"):
                resolve_device("cuda")


FAKE_REFERENCE = '''
import os
import torch


def run_rwkv6_forward(r, k, v, w, u):
    """The reference's CPU WKV6 (B, T, C) -> (B, T, C), here a plain loop."""
    assert os.environ["NO_CUDA"] == "1"
    N = int(os.environ["RWKV_HEAD_SIZE_A"])
    B, T, C = r.shape
    H = C // N
    r, k, v, w = (x.view(B, T, H, N).double() for x in (r, k, v, w))
    u = u.double()
    S = torch.zeros(B, H, N, N, dtype=torch.float64)
    out = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        out.append(torch.einsum("bhk,bhkv->bhv", r[:, t], u[None, :, :, None] * kv + S))
        S = S * torch.exp(-torch.exp(w[:, t]))[..., None] + kv
    return torch.stack(out, 1).reshape(B, T, C).float()
'''


def test_reference_wkv_crosscheck_restores_the_environment(files, tmp_path, monkeypatch):
    """With a reference checkout at $RWKV_REFERENCE_DIR (here a stand-in
    src/model_encoder_run.py), the first layer's WKV is held against its
    op (rel_err < 1e-5, as the JAX runbook's test holds it), and the
    variables and sys.path entry that its import needs are restored."""
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "model_encoder_run.py").write_text(FAKE_REFERENCE)
    monkeypatch.setenv("RWKV_REFERENCE_DIR", str(tmp_path))
    monkeypatch.setenv("RWKV_FLOAT_MODE", "bf16")
    monkeypatch.delenv("NO_CUDA", raising=False)
    before = (dict(os.environ), list(sys.path))
    model, _ = load_rwkv_checkpoint(files["model"], device="cpu", dtype="float32",
                                    param_dtype="float32")
    try:
        out = cli._reference_wkv_crosscheck(model, WorldTokenizer(), STS[0][0])
    finally:
        for name in [m for m in sys.modules if m == "src" or m.startswith("src.")]:
            del sys.modules[name]
    assert (dict(os.environ), list(sys.path)) == before
    assert out["tokens"] == len(WorldTokenizer().encode(STS[0][0]))
    assert out["rel_err"] < 1e-5 and out["y_scale"] > 0
