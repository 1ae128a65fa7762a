"""The port's speculative decoding (infer/speculative.py) against the JAX
package's and against its own engine, on the CPU, fp32; then through the
serving CLI and HTTP.

Sizes of tests/test_speculative.py: target 2 layers, C=64, head size 16,
vocab 160; draft 1 layer, C=32. The JAX models get seeded values in their
zero-initialised projections and are carried into the port by
checkpoint.convert, so both packages run the same weights; each JAX
SpeculativeEngine output is computed once per module. Greedy speculative
output must be token-identical to JAX's and to the port engine's
penalty-free greedy generate; the accept rule's first-token frequencies lie
within 0.01 of p[0] at N = 40,000 (about 4 sigma, as JAX's test holds them).
The serving tests run a 2-layer model over the world vocabulary (ids up to
65535)."""
import importlib.util
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.infer.speculative import SpeculativeEngine as JaxSpeculativeEngine
from rwkv_lm_ext_tpu.infer.speculative import truncated_draft as jax_truncated_draft
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into, save_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer import SpeculativeEngine
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.infer.speculative import (
    MAX_ROUNDS,
    _categorical,
    speculative_accept,
    truncated_draft,
)
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.serve import cli
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, make_fastapi_app, serve_http
from torch_stack_setup import torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers

VOCAB = 160
PLAIN_GREEDY = SamplingParams(temperature=0.0, alpha_presence=0.0, alpha_frequency=0.0,
                              token_stop=())
NO_PENALTY = dict(alpha_presence=0.0, alpha_frequency=0.0, token_stop=())
# (prompt, max_tokens, gamma) of JAX's three greedy cases
CASES = {"unrelated": ([5, 9, 23, 7], 10, 4), "self": ([5, 9, 23], 9, 4),
         "truncated": ([5, 9, 23], 8, 3)}


def _jax(n_layer, n_embd, seed, version=6.0):
    cfg = JaxModelConfig(n_layer=n_layer, n_embd=n_embd, vocab_size=VOCAB, head_size=16,
                         dtype="float32", param_dtype="float32", version=version)
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    return params, cfg


@pytest.fixture(scope="module")
def pair():
    """JAX target and draft, their port twins, and JAX's speculative greedy
    output of each case."""
    (tp, tc), (dp, dc) = _jax(2, 64, 5), _jax(1, 32, 9)
    drafts = {"unrelated": (dp, dc), "self": (tp, tc), "truncated": jax_truncated_draft(tp, tc, 1)}
    want = {}
    for name, (prompt, n, gamma) in CASES.items():
        spec = JaxSpeculativeEngine(tp, tc, *drafts[name], gamma=gamma, wkv_backend="reference",
                                    draft_wkv_backend="reference")
        want[name] = spec.generate(prompt, max_tokens=n, token_stop=())
    return torch_model(tp, tc), torch_model(dp, dc), want


def _draft(pair, name):
    target, draft, _ = pair
    return {"unrelated": draft, "self": target, "truncated": truncated_draft(target, 1)}[name]


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_matches_jax_and_the_engine(pair, name):
    target, _, want = pair
    prompt, n, gamma = CASES[name]
    spec = SpeculativeEngine(target, _draft(pair, name), gamma=gamma)
    out, stats = spec.generate(prompt, max_tokens=n, token_stop=(), return_stats=True)
    assert out == want[name]
    assert out == GenerationEngine(target).generate(prompt, max_tokens=n, sampling=PLAIN_GREEDY)
    assert stats.rounds >= 1 and 0.0 <= stats.acceptance <= 1.0
    if name == "self":
        # every proposal accepted: one verify pass a round, no correction
        assert stats.acceptance == 1.0 and stats.target_passes == 1 + stats.rounds
        assert stats.tokens_per_target_pass > 1.0


def test_truncated_draft_shares_the_target_modules(pair):
    target = pair[0]
    draft = truncated_draft(target, 1)
    assert draft.cfg.n_layer == 1 and len(draft.blocks) == 1
    assert draft.blocks[0] is target.blocks[0] and draft.emb.weight is target.emb.weight
    assert draft.head is target.head and len(target.blocks) == 2
    with pytest.raises(ValueError, match="draft-layers"):
        truncated_draft(target, 3)


def _port_model(cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen) * 0.5 / sd[key].shape[1] ** 0.5
    return load_state_dict_into(RWKV(cfg, device="cpu"), sd)


def test_rwkv4_target_rolls_back_by_prefill(pair):
    """A target the collect forward refuses (RWKV-4) runs the accepted
    prefix again from the round's start state: the engine's greedy output,
    one extra target pass per partial acceptance."""
    v4 = _port_model(ModelConfig(n_layer=2, n_embd=64, vocab_size=VOCAB, head_size=64,
                                 version=4.0, dtype="float32"), 3)
    prompt = [5, 9, 23, 7]
    want = GenerationEngine(v4).generate(prompt, max_tokens=10, sampling=PLAIN_GREEDY)
    spec = SpeculativeEngine(v4, pair[1], gamma=4)
    assert not spec.collect
    out, stats = spec.generate(prompt, max_tokens=10, token_stop=(), return_stats=True)
    assert out == want
    partial = stats.rounds - (stats.accepted == stats.proposed)
    assert stats.accepted < stats.proposed and stats.target_passes > 1 + stats.rounds
    assert stats.target_passes <= 1 + stats.rounds + partial
    self_out, self_stats = SpeculativeEngine(v4, v4, gamma=3).generate(
        prompt, max_tokens=10, token_stop=(), return_stats=True)
    assert self_out == want and self_stats.target_passes == 1 + self_stats.rounds


def test_speculative_accept_preserves_the_target_distribution():
    """The first emitted token (an accepted draft token or the resample) is
    distributed as p[0] for a mismatched draft q (tests/test_speculative.py:
    110-134), over N = 40,000 independent draws in one batched call."""
    V, N = 6, 40000
    p = torch.tensor([[0.4, 0.3, 0.1, 0.1, 0.05, 0.05], [0.1, 0.1, 0.2, 0.2, 0.2, 0.2]])
    q = torch.tensor([[0.05, 0.15, 0.3, 0.3, 0.1, 0.1]])
    gen = torch.Generator().manual_seed(0)
    cand = _categorical(q.expand(N, 1, V), gen)                     # (N, 1)
    j, nxt = speculative_accept(p.expand(N, 2, V), q.expand(N, 1, V), cand, gen)
    toks = torch.where(j > 0, cand[:, 0], nxt)
    freq = torch.bincount(toks, minlength=V).double() / N
    np.testing.assert_allclose(freq.numpy(), p[0].double().numpy(), atol=0.01)
    j1, n1 = speculative_accept(p, q, cand[0], torch.Generator().manual_seed(1))
    assert j1.shape == () and n1.shape == () and 0 <= int(j1) <= 1


def test_sampled_modes(pair):
    target, draft, _ = pair
    sp = SamplingParams(temperature=0.9, top_p=0.9, **NO_PENALTY)
    out, stats = SpeculativeEngine(target, target, gamma=4).generate(
        [5, 9, 23], max_tokens=10, sampling=sp, return_stats=True)
    assert len(out) == 10 and stats.acceptance == 1.0 and stats.target_passes == 1 + stats.rounds
    spec = SpeculativeEngine(target, draft, gamma=3)
    sp = SamplingParams(temperature=1.0, top_p=0.8, **NO_PENALTY)
    first, stats = spec.generate([5, 9], max_tokens=8, sampling=sp, seed=3, return_stats=True)
    assert len(first) == 8 and 0.0 <= stats.acceptance <= 1.0
    assert spec.generate([5, 9], max_tokens=8, sampling=sp, seed=3) == first


def test_round_modes_are_bounded(pair):
    """Each set of batch-shaping knobs gets its own rounds (buffers and, on a
    card, two graphs); past MAX_ROUNDS the least recently used goes, and a
    mode made again gives what it gave before."""
    target, draft, _ = pair
    spec = SpeculativeEngine(target, draft, gamma=2)
    greedy = spec.generate([5, 9], max_tokens=3, token_stop=())
    for top_k in range(1, MAX_ROUNDS + 3):
        sp = SamplingParams(temperature=1.0, top_k=top_k, **NO_PENALTY)
        spec.generate([5, 9], max_tokens=3, sampling=sp)
        assert len(spec._rounds) <= MAX_ROUNDS
    assert len(spec._rounds) == MAX_ROUNDS and ("greedy",) not in spec._rounds
    assert spec.generate([5, 9], max_tokens=3, token_stop=()) == greedy
    assert len(spec._rounds) == MAX_ROUNDS and ("greedy",) in spec._rounds


def test_refusals_stop_token_and_callback(pair):
    target, draft, _ = pair
    full = GenerationEngine(target).generate([5, 9, 23], max_tokens=8, sampling=PLAIN_GREEDY)
    stop = full[3]
    spec = SpeculativeEngine(target, draft, gamma=3)
    assert spec.generate([5, 9, 23], max_tokens=8, token_stop=(stop,)) == full[:3]
    sp_stop = SamplingParams(temperature=0.0, alpha_presence=0.0, alpha_frequency=0.0,
                             token_stop=(stop,))
    assert spec.generate([5, 9, 23], max_tokens=8, sampling=sp_stop) == full[:3]
    with pytest.raises(ValueError, match="token_ban"):
        spec.generate([5], sampling=SamplingParams(temperature=0.0, alpha_presence=0.0,
                                                   alpha_frequency=0.0, token_ban=(1,)))
    for sp in (SamplingParams(temperature=1.0), SamplingParams(temperature=0.0),
               SamplingParams(temperature=1.0, repetition_penalty=1.2, **NO_PENALTY)):
        with pytest.raises(ValueError, match="penalt"):
            spec.generate([5], sampling=sp)
    other = _port_model(ModelConfig(n_layer=1, n_embd=32, vocab_size=VOCAB + 1, head_size=16,
                                    dtype="float32"), 0)
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeEngine(target, other)
    seen = []
    out = SpeculativeEngine(target, draft, gamma=4).generate([5, 9, 23, 7], max_tokens=10,
                                                             token_stop=(), callback=seen.append)
    assert seen == out and len(out) == 10


# ---------------------------------------------------------------------------
# Serving: the CLI's flags and /generate over HTTP
# ---------------------------------------------------------------------------

GREEDY_HTTP = dict(temperature=0.0, top_p=1.0, alpha_presence=0.0, alpha_frequency=0.0,
                   token_stop=[])
PROMPT = "北京是 the capital"


@pytest.fixture(scope="module")
def world_files(tmp_path_factory):
    """A 2-layer target and a 1-layer draft over the world vocabulary, saved."""
    d = tmp_path_factory.mktemp("spec")
    target = _port_model(ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=32,
                                     dtype="float32"), 0)
    draft = _port_model(ModelConfig(n_layer=1, n_embd=32, vocab_size=65536, head_size=16,
                                    dtype="float32"), 1)
    save_rwkv_checkpoint(target, str(d / "m.pth"))
    save_rwkv_checkpoint(draft, str(d / "d.pth"))
    small = _port_model(ModelConfig(n_layer=1, n_embd=32, vocab_size=VOCAB, head_size=16,
                                    dtype="float32"), 2)
    save_rwkv_checkpoint(small, str(d / "small.pth"))
    return d, target


def _post(url, payload, raw=False):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            return resp.status, (body if raw else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(service):
    server = serve_http(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _service(d, *flags):
    return cli.build_service(cli.parse_args(
        ["--model", str(d / "m.pth"), "--platform", "cpu", "--dtype", "float32", "--port", "0",
         *flags]))


@pytest.mark.parametrize("flags", [["--draft-layers", "1", "--gamma", "3"],
                                   ["--draft", "d.pth"]], ids=["draft-layers", "draft"])
def test_cli_serves_speculative_generate(world_files, flags):
    d, target = world_files
    flags = [str(d / f) if f.endswith(".pth") else f for f in flags]
    service = _service(d, *flags)
    assert service.spec is not None and service.batcher is None
    assert service.spec.gamma == (3 if "--gamma" in flags else 8)
    want = GenerationEngine(target, WorldTokenizer()).generate(
        PROMPT, max_tokens=6, sampling=SamplingParams(**dict(GREEDY_HTTP, token_stop=())))
    server, thread, base = _serve(service)
    try:
        code, body = _post(base + "/generate", {"prompt": PROMPT, "max_tokens": 6, **GREEDY_HTTP})
        assert code == 200 and body == {"output": want, "backend": "speculative"}
        code, raw = _post(base + "/generate", {"prompt": PROMPT, "max_tokens": 6, "stream": True,
                                               **GREEDY_HTTP}, raw=True)
        events = [json.loads(e[len(b"data: "):]) for e in raw.split(b"\n\n") if e]
        assert code == 200 and events[-1]["done"] and events[-1]["backend"] == "speculative"
        assert "".join(e["token"] for e in events[:-1]) == events[-1]["output"] == want
        code, body = _post(base + "/generate", {"prompt": PROMPT, "max_tokens": 4,
                                                "temperature": 0.9, "top_p": 0.8,
                                                "alpha_presence": 0.0, "alpha_frequency": 0.0})
        assert code == 200 and body["backend"] == "speculative"
        # the default knobs carry occurrence penalties: the engine answers
        code, body = _post(base + "/generate", {"prompt": PROMPT, "max_tokens": 4})
        assert code == 200 and body["backend"] == "engine"
        # greedy rounds cannot honour token_ban: such a request is the
        # engine's (/generate takes no token_ban; other callers of the service may)
        no_penalty = dict(alpha_presence=0.0, alpha_frequency=0.0)
        assert not service._speculative(dict(no_penalty, temperature=0.0, token_ban=(1,)), None)
        assert service._speculative(dict(no_penalty, temperature=0.9, token_ban=(1,)), None)
        assert service._speculative(dict(no_penalty, temperature=0.0), None)
        code, stats = _post(base + "/stats", {})
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    spec = stats["speculative"]
    assert spec["rounds"] >= 3 and spec["proposed"] == spec["rounds"] * service.spec.gamma
    assert spec["acceptance"] == spec["accepted"] / spec["proposed"]
    assert stats["generate_latency_ms"]["speculative"]["count"] == 3


def test_cli_batcher_takes_precedence_and_refusals(world_files):
    d, _ = world_files
    service = _service(d, "--batcher-slots", "2", "--draft-layers", "1")
    assert service.spec is None and service.batcher is not None
    with pytest.raises(SystemExit, match="vocabulary"):
        _service(d, "--draft", str(d / "small.pth"))
    with pytest.raises(SystemExit, match="draft-layers"):
        _service(d, "--draft-layers", "5")
    service = _service(d)
    assert service.spec is None and "speculative" not in service.stats()


def test_make_fastapi_app_needs_fastapi():
    if importlib.util.find_spec("fastapi") is not None:
        pytest.skip("fastapi is installed: the refusal does not apply")
    with pytest.raises(ImportError, match="fastapi"):
        make_fastapi_app(ServingService())


def test_make_fastapi_app_routes(world_files):
    pytest.importorskip("fastapi")
    testclient = pytest.importorskip("fastapi.testclient")
    tok = WorldTokenizer()
    engine = GenerationEngine(world_files[1], tok)
    service = ServingService(engine=engine, tokenizer=tok,
                             spec_engine=SpeculativeEngine(engine.model,
                                                           truncated_draft(engine.model, 1), tok))
    client = testclient.TestClient(make_fastapi_app(service))
    resp = client.post("/generate", json={"prompt": PROMPT, "max_tokens": 3, **GREEDY_HTTP})
    assert resp.status_code == 200 and resp.json()["backend"] == "speculative"
    assert client.post("/nope", json={}).status_code == 404
