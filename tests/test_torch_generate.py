"""The port's generation stack on the CPU: sampling, streaming decode, the
engine and the /generate service, against the JAX package where it has a
counterpart.

Tolerances: the sampling filters keep the same tokens as JAX and their
values agree to rtol 1e-6 (the same fp32 operations); token picks given
JAX's own noise are equal; greedy generation is token-equal to the JAX
engine in fp32; block sizes give identical tokens and states (torch.equal).
"""
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
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.data.tokenizer import WorldTokenizer as JaxWorldTokenizer
from rwkv_lm_ext_tpu.infer.engine import GenerationEngine as JaxGenerationEngine
from rwkv_lm_ext_tpu.infer.engine import _chunk_plan as jax_chunk_plan
from rwkv_lm_ext_tpu.infer.sampling import SamplingParams as JaxSamplingParams
from rwkv_lm_ext_tpu.infer.sampling import penalize_and_filter as jax_penalize_and_filter
from rwkv_lm_ext_tpu.infer.sampling import sample_inverse_cdf as jax_sample_inverse_cdf
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into, save_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer import engine as engine_module
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine, _chunk_plan
from rwkv_lm_ext_tpu_torch.infer.sampling import (
    SamplingParams,
    inverse_cdf_pick,
    penalize_and_filter_rows,
    pick_token_rows,
    slot_params,
)
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.serve import cli
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http

torch.set_num_threads(1)  # tier-1 runs several pytest workers

GREEDY = dict(temperature=0.0, token_stop=())


def _jax_setup(seed=0):
    cfg = JaxModelConfig(n_layer=2, n_embd=128, vocab_size=1000, head_size=64,
                         dtype="float32", param_dtype="float32")
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    sd = jax_params_to_state_dict(params, cfg)
    model = load_state_dict_into(RWKV(sniff_model_config(sd, dtype="float32"), device="cpu"), sd)
    return params, cfg, model


@pytest.fixture(scope="module")
def small_model():
    return _jax_setup(seed=0)[2]


@pytest.mark.parametrize("n,chunk_len", [(1, 256), (7, 256), (300, 256), (513, 256), (37, 16), (5, 1), (100, 24)])
def test_chunk_plan_matches_jax(n, chunk_len):
    assert _chunk_plan(n, chunk_len) == jax_chunk_plan(n, chunk_len)
    assert sum(_chunk_plan(n, chunk_len)) == n


@pytest.mark.parametrize("knobs", [
    {},
    {"top_k": 20, "top_p": 1.0},
    {"top_p": 0.6, "top_p_impl": "bisect"},
    {"repetition_penalty": 1.3, "alpha_presence": 0.5, "alpha_frequency": 0.1},
    {"token_ban": (3, 7, 11), "top_p": 0.95},
])
@pytest.mark.parametrize("batched", [False, True])
def test_penalize_and_filter_matches_jax(knobs, batched):
    """The port's per-row penalties and filters, every row filled with the
    same knobs, against the JAX package's whole-batch ones on (B, V) and
    (V,) logits."""
    rng = np.random.default_rng(len(knobs))
    shape = (3, 300) if batched else (300,)
    logits = (rng.normal(size=shape) * 3).astype(np.float32)
    occ = (rng.integers(0, 3, size=shape) * (rng.uniform(size=shape) < 0.1)).astype(np.float32)
    want = np.asarray(jax_penalize_and_filter(jnp.asarray(logits), jnp.asarray(occ), JaxSamplingParams(**knobs)))
    sp, rows2d = SamplingParams(**knobs), (-1, shape[-1])
    got = penalize_and_filter_rows(torch.from_numpy(logits).reshape(rows2d),
                                   torch.from_numpy(occ).reshape(rows2d),
                                   slot_params(int(np.prod(shape[:-1])), sp, device="cpu"),
                                   sp).reshape(shape).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    kept = np.isfinite(want)
    assert 0 < kept.sum() < kept.size or knobs == {}
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=0)


def test_inverse_cdf_pick_with_jax_uniforms():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(16, 500)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_sample_inverse_cdf(key, jnp.asarray(logits)))
    u = np.array(jax.random.uniform(key, (16, 1), jnp.float32))
    got = inverse_cdf_pick(torch.from_numpy(logits), torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)


def test_gumbel_pick_with_jax_noise():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(16, 500)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    sp = SamplingParams()
    got = pick_token_rows(torch.from_numpy(logits), torch.from_numpy(noise),
                          slot_params(16, sp, device="cpu"), sp)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_matches_the_jax_engine():
    params, cfg, model = _jax_setup(seed=5)
    prompt = [5, 9, 23, 411, 7, 801, 33]
    want = JaxGenerationEngine(params, cfg).generate(
        prompt, max_tokens=16, sampling=JaxSamplingParams(**GREEDY), block_size=1)
    got = GenerationEngine(model).generate(prompt, max_tokens=16, sampling=SamplingParams(**GREEDY))
    assert got == [int(t) for t in want]


def test_block_size_changes_neither_tokens_nor_state(small_model):
    eng = GenerationEngine(small_model)
    sp = SamplingParams(temperature=1.0, top_p=0.9, token_stop=())
    ref, st_ref = eng.generate([5, 9, 23], max_tokens=11, sampling=sp, seed=7,
                               return_state=True, block_size=1)
    assert len(ref) == 11
    for k in (3, 8, 16):
        out, st = eng.generate([5, 9, 23], max_tokens=11, sampling=sp, seed=7,
                               return_state=True, block_size=k)
        assert out == ref, k
        assert all(torch.equal(st[key], st_ref[key]) for key in st), k
    assert eng.generate([5, 9, 23], max_tokens=11, sampling=sp, seed=8) != ref


def test_stop_token_mid_block_freezes_the_state(small_model):
    eng = GenerationEngine(small_model)
    full = eng.generate([5, 9, 23], max_tokens=8, sampling=SamplingParams(**GREEDY))
    sp = SamplingParams(temperature=0.0, token_stop=(full[3],))
    ref, st_ref = eng.generate([5, 9, 23], max_tokens=8, sampling=sp, return_state=True)
    assert ref == full[:3]
    _, st_3 = eng.generate([5, 9, 23], max_tokens=3, sampling=SamplingParams(**GREEDY),
                           return_state=True)
    out, st = eng.generate([5, 9, 23], max_tokens=8, sampling=sp, return_state=True, block_size=8)
    assert out == ref
    for key in st:
        assert torch.equal(st[key], st_ref[key]) and torch.equal(st[key], st_3[key])


def test_one_decoder_serves_every_knob_and_length(small_model):
    """The per-request knobs, stop tokens and budget are rows of one
    decoder's buffers: requests that share the batch-shaping knobs share it
    (and, on a card, its graphs), and each gives what a decoder of its own
    gives."""
    eng = GenerationEngine(small_model)
    cases = [(5, SamplingParams(**GREEDY)),
             (11, SamplingParams(temperature=0.6, top_p=0.5, repetition_penalty=1.3, token_stop=())),
             (7, SamplingParams(alpha_presence=1.0, alpha_frequency=0.5, token_stop=(0, 7)))]
    got = [eng.generate([5, 9, 23], max_tokens=n, sampling=sp, seed=2, block_size=4)
           for n, sp in cases]
    assert len(eng._decoders) == 1
    for (n, sp), out in zip(cases, got):
        assert out == GenerationEngine(small_model).generate([5, 9, 23], max_tokens=n, sampling=sp,
                                                             seed=2, block_size=4)
    assert len(got[1]) == 11


class _PieceTokenizer:
    """Each token streams as its own piece."""

    def streaming_decoder(self):
        class Decoder:
            def push(self, t):
                return f"<{t}>"

            def flush(self):
                return ""
        return Decoder()

    def decode(self, ids):
        return "".join(f"<{t}>" for t in ids)

    def encode(self, text):
        return [4 + ord(c) % 500 for c in text]


def test_default_block_size_streams_each_token_before_the_next_step(small_model, monkeypatch):
    """block_size=1 fetches after every step, so the callback for token i
    fires before step i + 1 runs; the library default, 16 as in the JAX
    engine, fires once the whole block has run: 16 steps, the ten past the
    budget of 6 frozen. The output is the same."""
    steps = []
    real_step = engine_module.rwkv_decode_step

    def counted(*args, **kwargs):
        steps.append(None)
        return real_step(*args, **kwargs)

    monkeypatch.setattr(engine_module, "rwkv_decode_step", counted)
    eng = GenerationEngine(small_model, _PieceTokenizer())
    seen = {}
    for block in (1, None):
        steps.clear()
        at = []
        kw = {} if block is None else {"block_size": block}
        out = eng.generate([5, 9], max_tokens=6, sampling=SamplingParams(**GREEDY),
                           callback=lambda piece: at.append(len(steps)), **kw)
        seen[block] = (out, at)
    assert seen[1][1] == [1, 2, 3, 4, 5, 6]
    assert seen[None][1] == [16] * 6
    assert seen[None][0] == seen[1][0]


def test_streaming_decoder_matches_jax_on_split_characters():
    tok, jtok = WorldTokenizer(), JaxWorldTokenizer(native=False)
    text = "北京 🚀 émoji 文字 ok"
    byte_id = {v[0]: k for k, v in tok.idx_to_token.items() if len(v) == 1}
    streams = [tok.encode(text), [byte_id[b] for b in text.encode("utf-8")]]
    for ids in streams:
        dec, jdec = tok.streaming_decoder(), jtok.streaming_decoder()
        pieces = [dec.push(t) for t in ids]
        assert pieces == [jdec.push(t) for t in ids]
        assert "".join(pieces) + dec.flush() == text == tok.decode(ids)
        assert jdec.flush() == ""
    assert tok.decode_bytes(streams[1]) == text.encode("utf-8")


def test_generate_batch_rows_match_generate(small_model):
    eng = GenerationEngine(small_model)
    prompts = [[5, 9, 23], [17, 4, 301]]
    sp = SamplingParams(**GREEDY)
    rows = eng.generate_batch(prompts, max_tokens=6, sampling=sp)
    assert rows == [eng.generate(p, max_tokens=6, sampling=sp) for p in prompts]
    stop = SamplingParams(temperature=0.0, token_stop=(rows[0][2],))
    assert eng.generate_batch(prompts, max_tokens=6, sampling=stop)[0] == rows[0][:2]


@pytest.fixture(scope="module")
def world_model():
    """A 2-layer model over the whole world vocabulary (ids up to 65535)."""
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=32, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen) * 0.5 / sd[key].shape[1] ** 0.5
    return load_state_dict_into(RWKV(cfg, device="cpu"), sd)


def _post(url, payload, raw=False):
    data = json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            return resp.status, (body if raw else json.loads(body))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _sse_events(body: bytes):
    return [json.loads(line[len(b"data: "):]) for line in body.split(b"\n\n") if line]


def test_http_generate_blocking_stream_errors_and_stats(world_model):
    tok = WorldTokenizer()
    service = ServingService(engine=GenerationEngine(world_model, tok))
    server = serve_http(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    prompt = "北京是 the capital"
    try:
        code, body = _post(base + "/generate", {"prompt": prompt, "max_tokens": 5, **GREEDY})
        assert code == 200 and body["backend"] == "engine"
        want = GenerationEngine(world_model, tok).generate(
            prompt, max_tokens=5, sampling=SamplingParams(**GREEDY))
        assert body["output"] == want
        code, raw = _post(base + "/generate", {"prompt": prompt, "max_tokens": 5, "stream": True,
                                               **GREEDY}, raw=True)
        events = _sse_events(raw)
        assert code == 200 and events[-1]["done"] and events[-1]["output"] == want
        assert "".join(e["token"] for e in events[:-1]) == want
        code, body = _post(base + "/generate", {"prompt": prompt, "max_tokens": 3,
                                                "temperature": 0.8, "top_p": 0.5,
                                                "alpha_presence": 0.1, "repetition_penalty": 1.2})
        assert code == 200 and isinstance(body["output"], str)
        assert _post(base + "/generate", {"prompt": prompt, "beam": 4})[0] == 400
        assert _post(base + "/generate", {"prompt": prompt, "beam": 4, "stream": True})[0] == 400
        assert _post(base + "/generate", {"max_tokens": 4})[0] == 400
        assert _post(base + "/generate", {"prompt": prompt, "temperature": "hot"})[0] == 400
        assert _post(base + "/embed", {"texts": ["x"]})[0] == 404   # no bi-encoder here
        code, stats = _post(base + "/stats", {})
        assert code == 200
        # a stream that fails validation answers 400 before it is counted
        assert stats["requests"]["/generate"] == 6 and "/embed" not in stats["requests"]
        lat = stats["generate_latency_ms"]["engine"]
        assert lat["count"] == 3 and 0 < lat["p50"] <= lat["p95"] <= lat["p99"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_sse_client_disconnect_cancels_the_generation(small_model, monkeypatch):
    """A streaming client that goes away stops the decode loop long before
    max_tokens, and the service answers the next request."""
    steps = []
    real_step = engine_module.rwkv_decode_step

    def counted(*args, **kwargs):
        steps.append(None)
        return real_step(*args, **kwargs)

    monkeypatch.setattr(engine_module, "rwkv_decode_step", counted)
    service = ServingService(engine=GenerationEngine(small_model, _PieceTokenizer()))
    server = serve_http(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        steps.clear()
        req = urllib.request.Request(base + "/generate", data=json.dumps(
            {"prompt": "x", "max_tokens": 2000, "stream": True, **GREEDY}).encode())
        resp = urllib.request.urlopen(req, timeout=60)
        assert resp.readline().startswith(b"data: ")
        resp.close()
        assert service._lock.acquire(timeout=60)      # the generation has stopped
        service._lock.release()
        assert 0 < len(steps) < 2000
        code, body = _post(base + "/generate", {"prompt": "x", "max_tokens": 2, **GREEDY})
        assert code == 200 and body["output"].count("<") == 2
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_cli_builds_an_int8c_service_on_the_cpu(world_model, tmp_path):
    path = str(tmp_path / "m.pth")
    save_rwkv_checkpoint(world_model, path)
    args = cli.parse_args(["--model", path, "--platform", "cpu", "--quant", "int8c",
                           "--dtype", "float32", "--port", "0"])
    service = cli.build_service(args)
    model = service.engine.model
    assert [type(model.blocks[0].att.key).__name__, model.blocks[0].att.key.mode] == ["QuantLinear", "int8c"]
    result = service.handle("/generate", {"prompt": "hello", "max_tokens": 3, **GREEDY})
    assert result["backend"] == "engine" and isinstance(result["output"], str)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.build_service(cli.parse_args(["--model", path]))
