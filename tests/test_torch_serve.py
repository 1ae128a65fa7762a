"""The port's tokenizer, bi-encoder and HTTP embedding service on the CPU."""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.data.tokenizer import WorldTokenizer as JaxWorldTokenizer
from rwkv_lm_ext_tpu.infer.encoders import _bucketize, _pad_batch
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into
from rwkv_lm_ext_tpu_torch.config import EMB_ID, ModelConfig
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.encoders import BiEncoder, bucketize, pad_batch
from rwkv_lm_ext_tpu_torch.models.heads import embed_sequences
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.serve.api import ServingService, serve_http

torch.set_num_threads(1)  # tier-1 runs several pytest workers

TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "北京是中华人民共和国的首都。",
    "emoji 🚀🎉 and mixed 文字 text",
]


@pytest.fixture(scope="module")
def tokenizer():
    return WorldTokenizer()


@pytest.fixture(scope="module")
def bi_encoder(tokenizer):
    # the world vocabulary emits ids up to 65535
    cfg = ModelConfig(n_layer=2, n_embd=128, vocab_size=65536, head_size=64, dtype="float32")
    sd = init_rwkv_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=g) * 0.5 / sd[key].shape[1] ** 0.5
    return BiEncoder(load_state_dict_into(RWKV(cfg, device="cpu"), sd), tokenizer)


def test_tokenizer_matches_jax_pure_python_trie(tokenizer):
    jax_tok = JaxWorldTokenizer(native=False)
    for text in TEXTS:
        ids = tokenizer.encode(text)
        assert ids == jax_tok.encode(text)
        assert tokenizer.decode(ids) == text
    assert tokenizer.vocab_size == jax_tok.vocab_size


def test_tokenizer_names_a_missing_vocabulary(tmp_path):
    with pytest.raises(FileNotFoundError, match="vocabulary"):
        WorldTokenizer(str(tmp_path / "missing.txt"))


@pytest.mark.parametrize("lengths", [[1], [3, 31, 32], [33, 7], [700, 2], [5000]])
def test_bucketing_matches_jax(lengths):
    ids = [list(range(2, 2 + n)) for n in lengths]
    assert bucketize(ids) == _bucketize(ids)
    np.testing.assert_array_equal(pad_batch(ids, bucketize(ids)), _pad_batch(ids, _bucketize(ids), 0))


def test_bi_encoder_embeds_like_embed_sequences(bi_encoder, tokenizer):
    got = bi_encoder.encode_texts(TEXTS * 2, batch_size=4)   # two forwards
    assert got.shape == (6, 128) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    ids = [tokenizer.encode(t) + [EMB_ID] for t in TEXTS]
    tokens = torch.from_numpy(pad_batch(ids, bucketize(ids)))
    with torch.no_grad():
        want = embed_sequences(bi_encoder.model, tokens, normalize=True)
    np.testing.assert_allclose(got[:3], want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3:], want.numpy(), rtol=1e-5, atol=1e-6)


def _post(url, payload):
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_embed_similarity_and_errors(bi_encoder):
    server = serve_http(ServingService(bi_encoder=bi_encoder), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        code, body = _post(base + "/embed", {"texts": TEXTS[:2]})
        assert code == 200
        emb = np.asarray(body["embeddings"])
        assert emb.shape == (2, 128) and np.isfinite(emb).all()
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
        code, body = _post(base + "/similarity", {"texts_a": TEXTS[:2], "texts_b": TEXTS[:2]})
        assert code == 200
        sim = np.asarray(body["similarity"])
        assert sim.shape == (2, 2) and np.all(np.diag(sim) >= 0.999)
        assert _post(base + "/embed", b"{not json")[0] == 400
        assert _post(base + "/embed", {"text": "wrong field"})[0] == 400
        assert _post(base + "/embed", {"texts": [1, 2]})[0] == 400
        assert _post(base + "/embed", {"texts": [""]})[0] == 400
        assert _post(base + "/similarity", {"texts_a": ["x"]})[0] == 400
        assert _post(base + "/generate", {"prompt": "x"})[0] == 404
        code, body = _post(base + "/stats", {})
        assert code == 200
        # the unparsable body never reaches the service
        assert body["requests"]["/embed"] == 4 and body["requests"]["/similarity"] == 2
        assert "/generate" not in body["requests"]   # unknown routes are not counted
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
