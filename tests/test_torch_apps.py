"""The port's demo applications and profiling utilities against the JAX
package's, on the same weights (fp32, 2 layers, n_embd 64, head size 16,
the world vocabulary; CPU, the kernels' plain versions):

- ``apps.rag``: ``LocalRetriever`` ranks a corpus in JAX's order with
  similarities within 1e-5 (the JAX bi-encoder on its sequential reference
  WKV, the recurrence the plain versions run); ``RagChat.answer`` gives
  JAX's greedy text and sources; ``main`` exits without CUDA by default.
- ``apps.kg``: ``KGExtractor.extract`` through a named state built from the
  same seed gives JAX's generation and JAX's parsed record, and on stub
  generations (JSON, JSON in noise, broken JSON, entries without names)
  JAX's records; ``build_graph`` / ``cluster_graph`` give JAX's nodes,
  edges, attributes and clusters (networkx); ``_extract_json`` and
  ``normalize_units`` JAX's values on tests/test_quant_kg.py's cases and
  more.
- ``utils.profiling``: ``Throughput`` equal to JAX's under a patched
  clock, ``record_time`` printing JAX's line, ``profile_trace`` writing a
  trace file.
"""
import json
import time
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.apps import kg as jkg
from rwkv_lm_ext_tpu.apps import rag as jrag
from rwkv_lm_ext_tpu.data.tokenizer import WorldTokenizer as JaxWorldTokenizer
from rwkv_lm_ext_tpu.infer import encoders as jenc
from rwkv_lm_ext_tpu.infer.engine import GenerationEngine as JaxGenerationEngine
from rwkv_lm_ext_tpu.infer.sampling import SamplingParams as JaxSamplingParams
from rwkv_lm_ext_tpu.infer.states_registry import StatesRegistry as JaxStatesRegistry
from rwkv_lm_ext_tpu.utils import profiling as jprofiling
import rwkv_lm_ext_tpu_torch.apps as papps
from rwkv_lm_ext_tpu_torch.apps import kg, rag
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.infer.states_registry import StatesRegistry
from rwkv_lm_ext_tpu_torch.utils import profiling
from torch_stack_setup import GREEDY, jax_params, torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers

DOCS = ["The Eiffel Tower is in Paris, the capital of France.",
        "Pandas eat bamboo in the mountains of Sichuan.",
        "北京是中华人民共和国的首都。",
        "RWKV is an RNN with transformer-level performance.",
        "The sky is blue because of Rayleigh scattering."]
QUESTION = "Where is the Eiffel Tower?"


@pytest.fixture(scope="module")
def world():
    """(JAX params, cfg, port model, port tokenizer, JAX tokenizer)."""
    params, cfg = jax_params(seed=51, n_layer=2, n_embd=64, vocab_size=65536, head_size=16)
    return params, cfg, torch_model(params, cfg), WorldTokenizer(), JaxWorldTokenizer()


@pytest.fixture(scope="module")
def retrievers(world):
    params, cfg, model, tok, jtok = world
    return (rag.LocalRetriever(BiEncoder(model, tok), DOCS),
            jrag.LocalRetriever(jenc.BiEncoder(params, cfg, jtok, wkv_backend="reference"), DOCS))


def test_local_retriever_matches_jax(retrievers):
    got_r, want_r = retrievers
    for query, k in ((QUESTION, 3), ("首都", 5), (DOCS[3], 2)):
        got, want = got_r.retrieve(query, k), want_r.retrieve(query, k)
        assert [d for _, d in got] == [d for _, d in want] and len(got) == k
        np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want], atol=1e-5)
    assert got_r.retrieve(DOCS[3], 1)[0][1] == DOCS[3]
    assert rag.LocalRetriever(got_r.bi, []).retrieve(QUESTION) == []


def test_local_retriever_add_matches_jax(world):
    params, cfg, model, tok, jtok = world
    got_r = rag.LocalRetriever(BiEncoder(model, tok), [])
    want_r = jrag.LocalRetriever(jenc.BiEncoder(params, cfg, jtok, wkv_backend="reference"), [])
    for r in (got_r, want_r):
        r.add(DOCS[:2])
        r.add(DOCS[2:])
    assert got_r.documents == want_r.documents == DOCS
    np.testing.assert_allclose(got_r._emb, want_r._emb, atol=1e-5)


def test_rag_chat_answer_matches_jax(world, retrievers):
    params, cfg, model, tok, jtok = world
    got_r, want_r = retrievers
    got = rag.RagChat(GenerationEngine(model, tok), got_r, top_k=2).answer(
        QUESTION, max_tokens=12, sampling=SamplingParams(**GREEDY))
    want = jrag.RagChat(JaxGenerationEngine(params, cfg, jtok, wkv_backend="reference"), want_r,
                        top_k=2).answer(QUESTION, max_tokens=12,
                                        sampling=JaxSamplingParams(**GREEDY))
    assert got == want
    assert len(got[1]) == 2 and got[0]
    assert rag.RAG_TEMPLATE == jrag.RAG_TEMPLATE


def test_rag_main_defaults_to_cuda(tmp_path):
    corpus = tmp_path / "docs.txt"
    corpus.write_text("\n".join(DOCS))
    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
            mock.patch.object(rag, "load_rwkv_checkpoint") as load, \
            pytest.raises(SystemExit, match="no CUDA device"):
        rag.main(["--model", "m.pth", "--corpus", str(corpus)])
    load.assert_not_called()


def test_kg_extract_through_a_named_state_matches_jax(world):
    """Greedy generation from a seeded named state (a template, fp32): the
    same text from both packages' registries, and the same record from
    both extractors (random weights emit no JSON, so both give the
    schema's two empty lists)."""
    params, cfg, model, tok, jtok = world
    states = 0.3 * np.random.default_rng(52).standard_normal(
        (cfg.n_layer, cfg.n_head, cfg.head_size, cfg.head_size)).astype(np.float32)
    template = "Extract entities and relations as JSON: {input}\nJSON:"
    reg, jreg = StatesRegistry(model.cfg, device="cpu"), JaxStatesRegistry(cfg)
    reg.register("kg_extract", states, template)
    jreg.register("kg_extract", jnp.asarray(states), template)
    engine = GenerationEngine(model, tok)
    jengine = JaxGenerationEngine(params, cfg, jtok, wkv_backend="reference")
    kw = dict(max_tokens=10)
    text = "Alice works for ACME in Paris."
    got_text = reg.generate(engine, "kg_extract", text, sampling=SamplingParams(**GREEDY), **kw)
    want_text = jreg.generate(jengine, "kg_extract", text, sampling=JaxSamplingParams(**GREEDY),
                              **kw)
    assert got_text == want_text and got_text
    assert got_text != engine.generate(template.format(input=text),
                                       sampling=SamplingParams(**GREEDY), **kw)
    got = kg.KGExtractor(engine, reg, max_tokens=10).extract(
        text, sampling=SamplingParams(**GREEDY))
    want = jkg.KGExtractor(jengine, jreg, max_tokens=10).extract(
        text, sampling=JaxSamplingParams(**GREEDY))
    assert got == want == {"entities": [], "relations": []}


class StubStates:
    """A states registry whose generation returns fixed outputs in turn."""

    def __init__(self, outputs):
        self.outputs = list(outputs)
        self.calls = []

    def generate(self, engine, name, text, **kw):
        self.calls.append((engine, name, text, kw))
        return self.outputs.pop(0)


STUB_OUTPUTS = [
    '{"entities": [{"name": "Alice", "type": "person"}, {"type": "x"}, "junk"], '
    '"relations": [{"head": "Alice", "type": "works_for", "tail": "ACME"}, {"head": "a"}]}',
    'noise before {"entities": [{"name": "3 km", "type": "quantity"}], "relations": []} after',
    '{"entities": [{"name": "broken"}',
    "no json at all",
    '{"relations": [{"head": "x", "tail": "y"}]}',
    ["not", "a", "string"],
]


def test_kg_extractor_parses_like_jax():
    got_s, want_s = StubStates(STUB_OUTPUTS), StubStates(STUB_OUTPUTS)
    got = kg.KGExtractor("engine", got_s, action="act", max_tokens=7).extract_corpus(
        [f"t{i}" for i in range(len(STUB_OUTPUTS))], seed=3)
    want = jkg.KGExtractor("engine", want_s, action="act", max_tokens=7).extract_corpus(
        [f"t{i}" for i in range(len(STUB_OUTPUTS))], seed=3)
    assert got == want and got_s.calls == want_s.calls
    assert got[0]["entities"] == [{"name": "Alice", "type": "person"}]
    assert kg.KGExtractor(None, None).schema == jkg.DEFAULT_SCHEMA == kg.DEFAULT_SCHEMA


RECORDS = [
    {"entities": [{"name": "ACME", "type": "organization"}, {"name": "Alice", "type": "person"}],
     "relations": [{"head": "Alice", "type": "works_for", "tail": "ACME"}]},
    {"entities": [{"name": "3 km", "type": "quantity"}, {"name": "3000 m"}],
     "relations": [{"head": "road", "type": "measures", "tail": "3 km"}]},
    {"entities": [],
     "relations": [{"head": "Alice", "type": "works_for", "tail": "ACME"},
                   {"head": "2 万", "tail": "20000 "}]},
    {"entities": [{"name": "Bob"}]},
]


@pytest.mark.parametrize("normalize", [True, False])
def test_graph_build_and_cluster_match_jax(normalize):
    pytest.importorskip("networkx")
    g, want = kg.build_graph(RECORDS, normalize=normalize), jkg.build_graph(RECORDS,
                                                                             normalize=normalize)
    assert dict(g.nodes(data=True)) == dict(want.nodes(data=True))
    assert sorted(g.edges(data=True)) == sorted(want.edges(data=True))
    assert kg.cluster_graph(g) == jkg.cluster_graph(want)
    assert len(kg.cluster_graph(g)) == (4 if normalize else 5)


@pytest.mark.parametrize("value", ["3 km", "2.5kg", "500 g", "plain text", "-1.5 MW", "7 万",
                                   "3e5 m", "12", " 4 cm ", "2 亿元", ""])
def test_normalize_units_matches_jax(value):
    assert kg.normalize_units(value) == jkg.normalize_units(value)


@pytest.mark.parametrize("text", ['noise {"entities": []} more', "no json here",
                                  'x {"a": {"b": 1}} y', '{"a": 1', '{bad} then {"ok": [1, 2]}',
                                  '[1, 2]', '} { "x": "}" }'])
def test_extract_json_matches_jax(text):
    assert kg._extract_json(text) == jkg._extract_json(text)


def test_apps_exports_match_jax():
    import rwkv_lm_ext_tpu.apps as japps

    names = {"KGExtractor", "build_graph", "cluster_graph", "normalize_units"}
    assert names <= set(vars(papps)) and names <= set(vars(japps))


def test_throughput_matches_jax_under_a_patched_clock():
    ticks = [10.0, 10.5, 10.75, 11.75, 11.75, 12.0]
    out = []
    for module in (profiling, jprofiling):
        clock = iter(ticks)
        with mock.patch.object(time, "perf_counter", lambda: next(clock)):
            meter = module.Throughput(ctx_len=512, real_bsz=8, ema=0.8)
            out.append([meter.step() for _ in ticks])
    assert out[0] == out[1]
    assert out[0][0] == {} and out[0][4]["it/s"] == float("inf")
    assert out[0][1]["Kt/s"] == pytest.approx(512 * 8 * 2.0 / 1000)


def test_record_time_prints_the_jax_line(capsys):
    lines = []
    for module in (profiling, jprofiling):
        @module.record_time
        def f(x):
            return x + 1

        @module.record_time(name="named")
        def g():
            return "g"

        assert (f(1), g()) == (2, "g") and f.__name__ == "f"
        lines.append([line.split(":")[0] for line in capsys.readouterr().out.splitlines()])
    assert lines[0] == lines[1] == ["[time] f", "[time] named"]


def test_record_time_waits_for_the_gpu():
    """Where the process has used a GPU, the clock is read after a
    synchronize at both ends."""
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "is_initialized", return_value=True), \
            mock.patch.object(torch.cuda, "synchronize") as sync:
        assert profiling.record_time(lambda: 3)() == 3
    assert sync.call_count == 2


def test_profile_trace_writes_a_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert log_dir == str(tmp_path / "trace")
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
