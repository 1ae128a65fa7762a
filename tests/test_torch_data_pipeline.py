"""The port's data pipeline against the JAX package's (numpy and stdlib
only on both sides, so every output is compared for equality): the MMIDIDX
binidx reader and writer (files byte for byte, each package reading the
other's), the magic-prime checks and the pretrain samplers sample for
sample, the preprocessing helpers and ``build_binidx`` (byte for byte), the
corpus converters and both CLIs' files, and ``GlmTokenizer`` on a synthetic
tiktoken-format model (skipped where tiktoken is not installed, as
tests/test_tokenizer_glm.py is). Last, a subprocess imports every module
this slice added with tiktoken, transformers, pyarrow, networkx and mteb
blocked: they are imported where they are used, never at import.
"""
import base64
import bz2
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rwkv_lm_ext_tpu.data import binidx as jbinidx
from rwkv_lm_ext_tpu.data import converters as jconv
from rwkv_lm_ext_tpu.data import preprocess as jprep
from rwkv_lm_ext_tpu.data import pretrain as jpretrain
from rwkv_lm_ext_tpu.data.tokenizer import WorldTokenizer as JaxWorldTokenizer
from rwkv_lm_ext_tpu_torch.data import binidx, converters, preprocess, pretrain
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["RWKV is an RNN with transformer-level performance. It trains in parallel!",
         "北京是中华人民共和国的首都。也是全国的政治和文化中心；对吗？",
         "Mixed 向量 embeddings 🚀 for retrieval... and it's fine",
         "  spaces\tand\nnewlines  "]


def _docs(seed: int, n: int = 7, high: int = 65535):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, high, size=int(rng.integers(1, 40))).tolist() for _ in range(n)]


def _write(module, prefix, docs, dtype):
    with module.IndexedDatasetWriter(str(prefix), dtype=dtype) as w:
        for d in docs:
            w.add_document(d)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.uint8, np.int64])
def test_binidx_files_are_byte_identical_and_read_both_ways(tmp_path, dtype):
    high = 255 if dtype == np.uint8 else 65535
    docs = _docs(1, high=high)
    _write(binidx, tmp_path / "port", docs, dtype)
    _write(jbinidx, tmp_path / "jax", docs, dtype)
    for ext in (".bin", ".idx"):
        assert _read(f"{tmp_path}/port{ext}") == _read(f"{tmp_path}/jax{ext}")
    for reader, prefix in ((binidx, "jax"), (jbinidx, "port")):
        ds, ref = reader.IndexedDataset(f"{tmp_path}/{prefix}"), jbinidx.IndexedDataset(
            f"{tmp_path}/jax")
        assert len(ds) == len(docs) and ds.dtype == np.dtype(dtype)
        assert ds.total_tokens == ref.total_tokens == sum(map(len, docs))
        for i, d in enumerate(docs):
            np.testing.assert_array_equal(ds[i], d)
            np.testing.assert_array_equal(ds.get(i, offset=len(d) // 2),
                                          ref.get(i, offset=len(d) // 2))
        np.testing.assert_array_equal(ds.slice_tokens(3, 20), ref.slice_tokens(3, 20))
        np.testing.assert_array_equal(ds.doc_idx, ref.doc_idx)
        np.testing.assert_array_equal(ds.pointers, ref.pointers)


def test_binidx_refuses_a_bad_header(tmp_path):
    _write(binidx, tmp_path / "c", [[1, 2, 3]], np.uint16)
    raw = bytearray(_read(tmp_path / "c.idx"))
    raw[0:1] = b"X"
    (tmp_path / "c.idx").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="bad magic"):
        binidx.IndexedDataset(str(tmp_path / "c"))


def test_prime_checks_match_jax():
    for n in [0, 1, 2] + list(range(4, 400)) + [7919, 104729, 1299709, 2**31 - 1, 561, 41041,
                                                 825265]:
        assert pretrain.fermat_prime_test(n) == jpretrain.fermat_prime_test(n), n
        assert pretrain.miller_rabin(n) == jpretrain.miller_rabin(n), n
        assert pretrain.maybe_is_prime(n) == jpretrain.maybe_is_prime(n), n
    # n = 3 draws its witness from an empty range in both (3 is never a
    # magic prime: those are 2 mod 3)
    for module in (pretrain, jpretrain):
        with pytest.raises(ValueError, match="low >= high"):
            module.miller_rabin(3)
    for tokens, ctx in ((10_000, 64), (123_457, 512), (2_000_003, 1024), (300, 16)):
        assert pretrain.pick_magic_prime(tokens, ctx) == jpretrain.pick_magic_prime(tokens, ctx)
    with pytest.raises(ValueError, match="no magic prime"):
        pretrain.pick_magic_prime(20, 16)
    with pytest.raises(ValueError, match="no magic prime"):
        jpretrain.pick_magic_prime(20, 16)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """A 20,000-token binidx stream and a QA set, written once."""
    d = tmp_path_factory.mktemp("pretrain")
    rng = np.random.default_rng(5)
    _write(binidx, d / "pile", [rng.integers(2, 1000, size=500).tolist() for _ in range(40)],
           np.uint16)
    qa = []
    for _ in range(9):
        doc = rng.integers(2, 1000, size=int(rng.integers(5, 30))).tolist()
        doc[int(rng.integers(0, len(doc)))] = 1          # the answer marker
        qa.append(doc)
    qa.append(rng.integers(2, 1000, size=50).tolist())   # no marker, longer than ctx
    _write(binidx, d / "qa", qa, np.uint16)
    return str(d / "pile"), str(d / "qa")


@pytest.mark.parametrize("world,rank,magic", [(1, 0, None), (4, 3, None), (2, 1, 311)])
def test_pretrain_sampler_matches_jax(stream, world, rank, magic):
    kw = dict(magic_prime=magic, world_size=world, rank=rank, epoch_steps=5, micro_bsz=3)
    port = pretrain.PretrainSampler(binidx.IndexedDataset(stream[0]), 64, **kw)
    ref = jpretrain.PretrainSampler(jbinidx.IndexedDataset(stream[0]), 64, **kw)
    assert (port.magic_prime, port.factor, port.samples_per_epoch) == (
        ref.magic_prime, ref.factor, ref.samples_per_epoch)
    for epoch in (0, 1, 7):
        for idx in (0, 1, 5, 14):
            assert port.sample_offset(epoch, idx) == ref.sample_offset(epoch, idx)
            a, b = port(epoch, idx), ref(epoch, idx)
            for key in ("input_ids", "labels"):
                assert a[key].dtype == b[key].dtype == np.int32
                np.testing.assert_array_equal(a[key], b[key])
        for a, b in zip(port.batches(epoch), ref.batches(epoch), strict=True):
            for key in ("input_ids", "labels"):
                np.testing.assert_array_equal(a[key], b[key])


def test_pretrain_sampler_refuses_a_bad_magic_prime(stream):
    data = binidx.IndexedDataset(stream[0])
    for magic, what in ((309, "not prime"), (307, "mod 3"), (1_000_037, "exceeds")):
        with pytest.raises(ValueError, match=what):
            pretrain.PretrainSampler(data, 64, magic_prime=magic)


def test_qa_masked_sampler_matches_jax(stream):
    pile, qa = stream
    port = pretrain.QAMaskedSampler(
        pretrain.PretrainSampler(binidx.IndexedDataset(pile), 32, epoch_steps=4),
        binidx.IndexedDataset(qa), 32, seed=3)
    ref = jpretrain.QAMaskedSampler(
        jpretrain.PretrainSampler(jbinidx.IndexedDataset(pile), 32, epoch_steps=4),
        jbinidx.IndexedDataset(qa), 32, seed=3)
    masked = 0
    for idx in range(24):
        a, b = port(0, idx), ref(0, idx)
        for key in ("input_ids", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
        masked += int((a["labels"] == -100).sum())
    assert masked > 0


@pytest.mark.parametrize("text", TEXTS)
def test_segments_match_jax(text):
    assert preprocess.split_sentences(text) == jprep.split_sentences(text)
    assert preprocess.word_segments(text) == jprep.word_segments(text)


@pytest.fixture(scope="module")
def tokenizers():
    return WorldTokenizer(), JaxWorldTokenizer()


def test_tokenize_with_segments_matches_jax(tokenizers):
    tok, jtok = tokenizers
    for text in TEXTS:
        ids, segs = preprocess.tokenize_with_segments(tok, text)
        assert (ids, segs) == jprep.tokenize_with_segments(jtok, text)
        assert len(ids) == len(segs) and segs == sorted(segs)


def test_iter_corpus_matches_jax(tmp_path):
    path = tmp_path / "c.jsonl"
    path.write_text("\n".join([json.dumps({"text": TEXTS[0]}), "plain line", "",
                               json.dumps(["a", "list"]), '{"no_text": 1}', "{broken json",
                               json.dumps({"text": TEXTS[1]}, ensure_ascii=False)]),
                    encoding="utf-8")
    got = list(preprocess.iter_corpus(str(path)))
    assert got == list(jprep.iter_corpus(str(path))) and len(got) == 6
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    pq.write_table(pa.table({"text": TEXTS, "other": list(range(4))}), str(tmp_path / "c.parquet"))
    assert list(preprocess.iter_corpus(str(tmp_path / "c.parquet"))) == list(
        jprep.iter_corpus(str(tmp_path / "c.parquet"))) == TEXTS


@pytest.mark.parametrize("append_eos", [True, False])
def test_build_binidx_is_byte_identical(tmp_path, tokenizers, append_eos):
    tok, jtok = tokenizers
    corpus = tmp_path / "corpus.jsonl"
    corpus.write_text("\n".join(json.dumps({"text": t}, ensure_ascii=False) for t in TEXTS),
                      encoding="utf-8")
    n = preprocess.build_binidx(str(corpus), str(tmp_path / "port"), tok, append_eos=append_eos)
    m = jprep.build_binidx(str(corpus), str(tmp_path / "jax"), jtok, append_eos=append_eos)
    assert n == m == binidx.IndexedDataset(str(tmp_path / "port")).total_tokens
    for ext in (".bin", ".idx"):
        assert _read(f"{tmp_path}/port{ext}") == _read(f"{tmp_path}/jax{ext}")


def test_preprocess_cli_writes_the_jax_files(tmp_path, capsys):
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n".join(TEXTS), encoding="utf-8")
    preprocess.main(["build-binidx", "--input", str(corpus), "--output", str(tmp_path / "port"),
                     "--append-eos"])
    jprep.main(["build-binidx", "--input", str(corpus), "--output", str(tmp_path / "jax"),
                "--append-eos"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("port", "jax") == out[1]
    for ext in (".bin", ".idx"):
        assert _read(f"{tmp_path}/port{ext}") == _read(f"{tmp_path}/jax{ext}")


COIG = [
    {"input": "a", "instruction": "b", "output": "c",
     "task_type": {"major": ["阅读理解"], "minor": ["其他"]}},
    {"input": "x", "instruction": "y", "output": "z", "task_type": {"major": ["代码"], "minor": []}},
    {"input": "m", "instruction": "n", "output": "o", "task_type": {"major": "分类",
                                                                   "minor": "阅读理解题"}},
    {"instruction": "only", "task_type": None},
]
DRCD = {"data": [{"paragraphs": [
    {"context": "ctx", "qas": [{"question": "q1", "answers": [{"text": "a1"}, {"text": "a2"}]},
                               {"question": "q2", "answers": []}]},
    {"context": "ctx2", "qas": [{"question": "q3", "answers": [{"text": "a3"}]}]}]},
    {"paragraphs": []}]}
IEPILE = [
    {"task": "NER", "output": "[]", "instruction": json.dumps(
        {"instruction": "ner please", "input": "text", "schema": ["PER"]})},
    {"task": "RE", "output": "[]", "instruction": json.dumps(
        {"instruction": "re", "input": "t", "schema": []})},
    {"task": "NER", "output": "[1]", "instruction": {"instruction": "dict", "input": "中文"}},
    {"input": "plain", "output": "out"},
]
WIKI = """<mediawiki xmlns="http://www.mediawiki.org/xml/export-0.10/">
<page><title>Alpha</title><ns>0</ns><revision><text>
{{Infobox|thing={{nested|x}}}}'''Alpha''' is a [[letter|Greek letter]] used in [[math]].
== History ==
It has &lt;ref name="a"&gt;cite&lt;/ref&gt; a long history.&lt;!-- hidden --&gt;{{cn}}
{| class="wikitable"
| a || b
|}
* item one
# item two
[[File:Alpha.png|thumb|a [[caption]] here]]
[https://example.com ext link] end.



Last paragraph.
</text></revision></page>
<page><title>Redir</title><ns>0</ns><redirect title="Alpha"/>
<revision><text>#REDIRECT [[Alpha]] with enough characters to pass any filter at all</text></revision></page>
<page><title>Talk:Alpha</title><ns>1</ns><revision><text>talk page content that is long enough to pass the filter easily</text></revision></page>
<page><title>Short</title><ns>0</ns><revision><text>too short</text></revision></page>
<page><title>北京</title><ns>0</ns><revision><text>'''北京'''是[[中华人民共和国]]的首都，也是全国的政治和文化中心。</text></revision></page>
</mediawiki>"""


def test_converters_match_jax():
    assert list(converters.convert_coig_records(COIG)) == list(jconv.convert_coig_records(COIG))
    assert list(converters.convert_coig_records(COIG, "代码")) == list(
        jconv.convert_coig_records(COIG, "代码"))
    assert list(converters.convert_drcd(DRCD)) == list(jconv.convert_drcd(DRCD))
    for task in ("NER", "RE"):
        assert list(converters.convert_iepile_records(IEPILE, task)) == list(
            jconv.convert_iepile_records(IEPILE, task))
    with pytest.raises(ValueError, match="IEPile record"):
        list(converters.convert_iepile_records([{"output": "x"}]))
    assert converters.IE_DEFAULT_INSTRUCTION == jconv.IE_DEFAULT_INSTRUCTION


@pytest.mark.parametrize("min_chars", [16, 64])
def test_wiki_dump_matches_jax(tmp_path, min_chars):
    (tmp_path / "dump.xml").write_text(WIKI, encoding="utf-8")
    (tmp_path / "dump.xml.bz2").write_bytes(bz2.compress(WIKI.encode()))
    for name in ("dump.xml", "dump.xml.bz2"):
        path = str(tmp_path / name)
        got = list(converters.convert_wiki_dump(path, min_chars=min_chars))
        assert got == list(jconv.convert_wiki_dump(path, min_chars=min_chars))
        assert got and got[0]["title"] == "Alpha" and "{{" not in got[0]["text"]
    assert list(converters.convert_wiki_dump(str(tmp_path / "dump.xml"), min_chars=16,
                                             skip_redirects=False)) == list(
        jconv.convert_wiki_dump(str(tmp_path / "dump.xml"), min_chars=16, skip_redirects=False))


def test_converter_cli_files_match_jax(tmp_path, capsys):
    coig, iepile = tmp_path / "coig.jsonl", tmp_path / "iepile.jsonl"
    coig.write_text("\n".join(json.dumps(r, ensure_ascii=False) for r in COIG), encoding="utf-8")
    iepile.write_text("\n".join(json.dumps(r, ensure_ascii=False) for r in IEPILE),
                      encoding="utf-8")
    (tmp_path / "drcd.json").write_text(json.dumps(DRCD), encoding="utf-8")
    (tmp_path / "dump.xml.bz2").write_bytes(bz2.compress(WIKI.encode()))
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    rows = [r for r in COIG if isinstance((r.get("task_type") or {}).get("major"), list)]
    pq.write_table(pa.Table.from_pylist(rows), str(tmp_path / "coig.parquet"))
    runs = [["coig", "--input", str(coig)], ["coig", "--input", str(tmp_path / "coig.parquet")],
            ["coig", "--input", str(coig), "--task-type", "代码"],
            ["drcd", "--input", str(tmp_path / "drcd.json")],
            ["iepile", "--input", str(iepile), "--task", "RE"],
            ["wiki", "--input", str(tmp_path / "dump.xml.bz2"), "--min-chars", "16"]]
    for i, argv in enumerate(runs):
        port, ref = tmp_path / f"port{i}.jsonl", tmp_path / f"jax{i}.jsonl"
        converters.main(argv + ["--output", str(port)])
        jconv.main(argv + ["--output", str(ref)])
        assert _read(port) == _read(ref) and _read(port), argv
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].replace(str(port), str(ref)) == lines[1]


@pytest.fixture(scope="module")
def glm_model(tmp_path_factory):
    """The byte-level tiktoken-format table of tests/test_tokenizer_glm.py,
    plus a few merged tokens."""
    pytest.importorskip("tiktoken")
    p = tmp_path_factory.mktemp("glm") / "tokenizer.model"
    tokens = [bytes([b]) for b in range(256)] + [b"th", b"the", b" the", "首都".encode()]
    p.write_text("\n".join(f"{base64.b64encode(t).decode()} {i}" for i, t in enumerate(tokens))
                 + "\n")
    return str(p)


def test_glm_tokenizer_matches_jax(glm_model):
    from rwkv_lm_ext_tpu.data.tokenizer_glm import GlmTokenizer as JaxGlmTokenizer
    from rwkv_lm_ext_tpu_torch.data import tokenizer_glm

    tok, ref = tokenizer_glm.GlmTokenizer(glm_model), JaxGlmTokenizer(glm_model)
    assert (tok.emb_id, tok.mask_id, tok.pad_id, tok.vocab_size) == (
        ref.emb_id, ref.mask_id, ref.pad_id, ref.vocab_size)
    assert tokenizer_glm._SPECIALS == __import__(
        "rwkv_lm_ext_tpu.data.tokenizer_glm", fromlist=["_SPECIALS"])._SPECIALS
    for text in TEXTS + ["the theme of the 首都", "x<|endoftext|>y"]:
        ids = tok.encode(text)
        assert ids == ref.encode(text)
        assert tok.decode(ids) == ref.decode(ids) == text
        assert tok.decode(ids + [tokenizer_glm.GLM_EMB_ID, tokenizer_glm.GLM_PAD_ID]) == text
    assert tok.encode("the") == [257]


def test_new_modules_import_without_the_optional_packages():
    """Importing every module this slice added loads none of tiktoken,
    transformers, pyarrow, networkx and mteb, and succeeds with them
    blocked."""
    code = (
        "import importlib, sys\n"
        "blocked = ('tiktoken', 'transformers', 'pyarrow', 'networkx', 'mteb')\n"
        "for name in blocked:\n"
        "    sys.modules[name] = None\n"
        "for name in ('data.binidx', 'data.pretrain', 'data.preprocess', 'data.converters',\n"
        "             'data.tokenizer_glm', 'eval', 'eval.retrieval', 'eval.tasks',\n"
        "             'eval.mteb_adapter', 'eval.cli', 'apps', 'apps.kg', 'apps.rag', 'utils',\n"
        "             'utils.profiling'):\n"
        "    importlib.import_module('rwkv_lm_ext_tpu_torch.' + name)\n"
        "from rwkv_lm_ext_tpu_torch.eval.mteb_adapter import MtebBiEncoder, run_mteb\n"
        "try:\n"
        "    run_mteb(MtebBiEncoder(object()), ['MMarcoRetrieval'])\n"
        "except ImportError as e:\n"
        "    assert 'mteb' in str(e)\n"
        "else:\n"
        "    raise SystemExit('run_mteb ran without mteb')\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr
