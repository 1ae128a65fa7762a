"""The port's reranking and multi-adapter serving path (CPU, the kernels'
plain versions) against the JAX package on the same weights (fp32, 2 layers,
n_embd 128, the world vocabulary): ``CrossEncoder.score_pairs`` in fp32 and
int8c, ``BiEncoder`` with a dense head, ``BiCrossFusionEncoder`` with three
adapters used in turns, ``/rerank`` and ``/embed`` through ServingService
and serve_http, and the serving CLI's ``--bi-adapter`` / ``--cross-adapter``
/ ``--cross-head``.

Tolerances: scores and embeddings within 1e-5 of the largest |JAX value|
(the JAX side on its sequential reference WKV, as the port's plain
versions run), int8c scores within 1e-3 of it (tests/test_torch_quant.py's
int8c bound); greedy generations and rankings equal.
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

from rwkv_lm_ext_tpu.adapters import LoraConfig as JaxLoraConfig
from rwkv_lm_ext_tpu.adapters import init_lora_params as jax_init_lora_params
from rwkv_lm_ext_tpu.adapters.quant import quantize_tree
from rwkv_lm_ext_tpu.infer import encoders as jenc
from rwkv_lm_ext_tpu.infer.beam import BeamParams as JaxBeamParams
from rwkv_lm_ext_tpu.infer.sampling import SamplingParams as JaxSamplingParams
from rwkv_lm_ext_tpu.models.heads import init_embedding_head
from rwkv_lm_ext_tpu.serve.api import ServingService as JaxServingService
from rwkv_lm_ext_tpu_torch.adapters.lora import LoraConfig, apply_lora, lora_state_dict, merge_lora
from rwkv_lm_ext_tpu_torch.adapters.quant import quantize_model
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    embedding_head_from_jax,
    lora_tree_from_jax,
    save_rwkv_checkpoint,
    score_head_from_jax,
)
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.beam import BeamParams
from rwkv_lm_ext_tpu_torch.infer.encoders import (
    PAIR_BUDGET,
    BiCrossFusionEncoder,
    BiEncoder,
    CrossEncoder,
    pair_ids,
)
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.serve import cli
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http
from torch_stack_setup import GREEDY, jax_params, torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REF = "reference"    # the JAX package's sequential WKV
QUERY = "Which city is the capital of France?"
DOCS = ["Paris is the capital and largest city of France.",
        "北京是中华人民共和国的首都。",
        "Bananas are rich in potassium 🍌.",
        "France borders Spain, Italy and Germany; its capital is Paris."]
LC, JLC = LoraConfig(r=4, alpha=16.0), JaxLoraConfig(r=4, alpha=16.0)


@pytest.fixture(scope="module")
def world():
    """(JAX params, cfg, port model, tokenizer) with the world vocabulary's
    size, and a score head in both layouts."""
    params, cfg = jax_params(seed=21, vocab_size=65536)
    score = {"kernel": jnp.asarray(np.random.default_rng(22).standard_normal((cfg.n_embd, 1)),
                                   jnp.float32)}
    return params, cfg, torch_model(params, cfg), WorldTokenizer(), score


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _adapter(params, seed):
    """A JAX adapter with B filled (at B = 0 the adapter changes nothing)."""
    adapter = jax_init_lora_params(jax.random.PRNGKey(seed), params, JLC)
    rng = np.random.default_rng(seed)
    return {k: {"A": ab["A"], "B": jnp.asarray(rng.normal(size=ab["B"].shape) * 0.1, jnp.float32)}
            for k, ab in adapter.items()}


def test_pairs_keep_the_jax_budget(world):
    """q [SEP] d [CLS]; past 2046 tokens the document is cut first, then
    the query."""
    tok = world[3]
    short = pair_ids(tok, QUERY, DOCS[0])
    assert short == tok.encode(QUERY) + [2] + tok.encode(DOCS[0]) + [1]
    q, d = tok.encode("q " * 1500), tok.encode("d " * 1500)
    assert len(q) + len(d) > PAIR_BUDGET
    assert pair_ids(tok, "q " * 1500, "d " * 1500) == q + [2] + d[: PAIR_BUDGET - len(q)] + [1]
    long_q = tok.encode("q " * 2500)
    assert pair_ids(tok, "q " * 2500, "d " * 1500) == long_q[:PAIR_BUDGET] + [2, 1]


@pytest.mark.parametrize("quant", [None, "int8c"])
def test_cross_encoder_scores_match_jax(world, quant):
    params, cfg, model, tok, score = world
    jparams = params if quant is None else quantize_tree(params, mode=quant)
    want = jenc.CrossEncoder(jparams, cfg, tok, score, wkv_backend=REF).score_pairs(
        [(QUERY, d) for d in DOCS], batch_size=3)
    if quant is not None:
        model = torch_model(params, cfg)
        quantize_model(model, quant)
    got = CrossEncoder(model, tok, score_head_from_jax(score)).score_pairs(
        [(QUERY, d) for d in DOCS], batch_size=3)
    assert got.shape == (4,) and got.dtype == np.float32
    _close(got, want, 1e-5 if quant is None else 1e-3)


def test_bi_encoder_with_a_dense_head_matches_jax(world):
    params, cfg, model, tok, _ = world
    head = init_embedding_head(jax.random.PRNGKey(23), cfg, output_dim=64)
    want = jenc.BiEncoder(params, cfg, tok, head_params=head, wkv_backend=REF).encode_texts(DOCS)
    got = BiEncoder(model, tok, head=embedding_head_from_jax(head)).encode_texts(DOCS)
    assert got.shape == (4, 64)
    _close(got, want, 1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_fusion_encoder_interleaves_three_adapters_like_jax(world):
    """Embedding, reranking and chat adapters on one base, used in turns
    (embed, rerank, generate, embed, rerank, beam search): each answer as
    the JAX class gives it, and each adapter's answer as its merged model
    alone gives it."""
    params, cfg, model, tok, score = world
    bi, cross, chat = (_adapter(params, s) for s in (31, 32, 33))
    jfuse = jenc.BiCrossFusionEncoder(
        params, cfg, tok, bi_adapter=bi, bi_lora_cfg=JLC, cross_adapter=cross, cross_lora_cfg=JLC,
        score_params=score, chat_adapter=chat, chat_lora_cfg=JLC, wkv_backend=REF)
    fuse = BiCrossFusionEncoder(
        model, tok, bi_adapter=lora_tree_from_jax(bi), bi_lora_cfg=LC,
        cross_adapter=lora_tree_from_jax(cross), cross_lora_cfg=LC,
        score=score_head_from_jax(score), chat_adapter=lora_tree_from_jax(chat), chat_lora_cfg=LC)
    pairs = [(QUERY, d) for d in DOCS]
    e1 = fuse.encode_texts(DOCS[:2])
    s1 = fuse.cross_encode_texts(pairs)
    g = fuse.sampling_generate("Hello", max_tokens=4, sampling=SamplingParams(**GREEDY))
    e2, s2 = fuse.encode_texts(DOCS[:2]), fuse.cross_encode_texts(pairs)
    assert np.array_equal(e1, e2) and np.array_equal(s1, s2)
    _close(e1, jfuse.encode_texts(DOCS[:2]), 1e-5)
    _close(s1, jfuse.cross_encode_texts(pairs), 1e-5)
    assert g == jfuse.sampling_generate("Hello", max_tokens=4,
                                        sampling=JaxSamplingParams(**GREEDY))
    knobs = dict(num_beams=2, num_groups=1, return_num_sequences=2, max_tokens=3,
                 do_sample=False, eos_ids=(0,))
    beams = fuse.beam_generate("Hello", beam_params=BeamParams(**knobs))
    want = jfuse.beam_generate("Hello", beam_params=JaxBeamParams(**knobs))
    assert [t for _, t in beams] == [t for _, t in want]
    np.testing.assert_allclose([s for s, _ in beams], [s for s, _ in want], rtol=1e-4, atol=1e-4)
    # each adapter really is in use: its merged model alone gives the answers
    alone = merge_lora(apply_lora(torch_model(params, cfg), LC, lora_tree_from_jax(cross)))
    np.testing.assert_array_equal(
        CrossEncoder(alone, tok, score_head_from_jax(score)).score_pairs(pairs), s1)
    assert not np.allclose(CrossEncoder(model, tok, score_head_from_jax(score)).score_pairs(pairs),
                           s1)
    with pytest.raises(ValueError, match="score head"):
        BiCrossFusionEncoder(model, tok).cross_encode_texts(pairs)


def _post(url, payload):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Served:
    def __init__(self, service):
        self.server = serve_http(service, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def __enter__(self):
        return self.base

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def test_rerank_and_embed_over_http_match_jax_service(world):
    params, cfg, model, tok, score = world
    service = ServingService(bi_encoder=BiEncoder(model, tok),
                             cross_encoder=CrossEncoder(model, tok, score_head_from_jax(score)))
    jservice = JaxServingService(
        bi_encoder=jenc.BiEncoder(params, cfg, tok, wkv_backend=REF),
        cross_encoder=jenc.CrossEncoder(params, cfg, tok, score, wkv_backend=REF))
    want = jservice.rerank(QUERY, DOCS)
    with _Served(service) as base:
        code, body = _post(base + "/rerank", {"query": QUERY, "documents": DOCS})
        assert code == 200 and sorted(body) == ["ranking", "scores"]
        _close(body["scores"], want["scores"], 1e-5)
        assert body["ranking"] == want["ranking"]
        assert body["ranking"] == list(np.argsort(-np.asarray(body["scores"])))
        # an empty document is a pair like any other
        code, body = _post(base + "/rerank", {"query": QUERY, "documents": [""]})
        assert code == 200 and len(body["scores"]) == 1
        code, body = _post(base + "/embed", {"texts": DOCS[:2]})
        assert code == 200
        _close(body["embeddings"], jservice.embed(DOCS[:2])["embeddings"], 1e-5)
        for bad in (b"{not json", {"documents": DOCS}, {"query": 3, "documents": DOCS},
                    {"query": QUERY}, {"query": QUERY, "documents": []},
                    {"query": QUERY, "documents": "one"}, {"query": QUERY, "documents": [1]}, []):
            assert _post(base + "/rerank", bad)[0] == 400, bad
        code, stats = _post(base + "/stats", {})
        assert stats["requests"]["/rerank"] == 9
    with _Served(ServingService(bi_encoder=BiEncoder(model, tok))) as base:
        assert _post(base + "/rerank", {"query": QUERY, "documents": DOCS})[0] == 404
        assert _post(base + "/embed", {"texts": ["x"]})[0] == 200


def test_cli_serves_rerank_and_embed_through_adapters(world, tmp_path):
    """--cross-adapter with score.weight inside it or beside it in
    --cross-head, --bi-adapter, and the refusal without a score head; the
    reranker and the bi-encoder run on the unquantized merged weights while
    --quant int8c quantizes the generation model only, as the JAX CLI does."""
    params, cfg, model, tok, score = world
    path = str(tmp_path / "m.pth")
    save_rwkv_checkpoint(model, path)
    merged = {}
    for name, seed in (("bi", 41), ("cross", 42)):
        adapted = apply_lora(torch_model(params, cfg), LC, lora_tree_from_jax(_adapter(params, seed)))
        torch.save(lora_state_dict(adapted), tmp_path / f"{name}.pth")
        merged[name] = merge_lora(adapted)
    head = {"score.weight": torch.from_numpy(np.asarray(score["kernel"]).T.copy())}
    torch.save(head, tmp_path / "score.pth")
    torch.save({**torch.load(tmp_path / "cross.pth"), **head}, tmp_path / "cross_with_head.pth")
    want = CrossEncoder(merged["cross"], tok, score_head_from_jax(score)).score_pairs(
        [(QUERY, d) for d in DOCS])
    common = ["--model", path, "--platform", "cpu", "--dtype", "float32", "--lora-r", "4",
              "--lora-alpha", "16"]
    for flags in (["--cross-adapter", str(tmp_path / "cross_with_head.pth")],
                  ["--cross-adapter", str(tmp_path / "cross.pth"), "--cross-head",
                   str(tmp_path / "score.pth"), "--quant", "int8c",
                   "--bi-adapter", str(tmp_path / "bi.pth"), "--bi-pooling", "lasttoken"]):
        service = cli.build_service(cli.parse_args(common + flags))
        assert "/rerank" in service.routes
        got = service.handle("/rerank", {"query": QUERY, "documents": DOCS})
        np.testing.assert_allclose(got["scores"], want, rtol=1e-6, atol=1e-6)
    emb = service.handle("/embed", {"texts": DOCS[:2]})["embeddings"]
    np.testing.assert_allclose(emb, BiEncoder(merged["bi"], tok, pooling_type="lasttoken").encode_texts(
        DOCS[:2]), rtol=1e-6, atol=1e-6)
    assert type(service.engine.model.blocks[0].att.key).__name__ == "QuantLinear"
    with pytest.raises(SystemExit, match="score.weight"):
        cli.build_service(cli.parse_args(common + ["--cross-adapter", str(tmp_path / "cross.pth")]))
    with pytest.raises(SystemExit, match="need --model"):
        cli.build_service(cli.parse_args(["--platform", "cpu", "--encoder", path,
                                          "--cross-adapter", str(tmp_path / "cross.pth")]))
