"""The port's bidirectional encoders (CPU, the kernels' plain versions) against
the JAX package on the same weights and tokens: ``sequence_lengths``,
``bi_time_mix``, ``encoder_forward`` and ``encode_sentence`` in both modes, the
RetroMAE forward with its one-layer decoder, the streaming variant, the MLM
head, fp32 master weights, and ``/fill_mask``.

Tolerances: 1e-4 of the largest |JAX value| in fp32 (the JAX side runs its
chunked WKV factoring on the CPU, the port the sequential recurrence); 2e-5
for the streaming variant, the JAX test's own tolerance; bf16 compute over
fp32 masters within 2e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.data.tokenizer import WorldTokenizer as JaxWorldTokenizer
from rwkv_lm_ext_tpu.models import bidirectional as jbi
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.models.heads import mlm_logits as jax_mlm_logits
from rwkv_lm_ext_tpu.models.state import unpack_wkv as jax_unpack_wkv
from rwkv_lm_ext_tpu.serve.api import ServingService as JaxServingService
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    load_state_dict_into,
    one_layer_decoder_from_jax,
)
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.models import bidirectional as bi
from rwkv_lm_ext_tpu_torch.models.heads import mlm_logits
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.serve.api import BadRequest, ServingService, UnknownRoute

torch.set_num_threads(1)  # tier-1 runs several pytest workers

VOCAB = 300
MODES = ["average", "fused"]


def _close(got, want, rel, name=""):
    got, want = (a.detach().float().numpy() if isinstance(a, torch.Tensor) else a
                 for a in (got, want))
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (name, err, np.abs(want).max())


def _setup(seed=0, vocab=VOCAB, n_embd=128, emb_scale=0.3, **torch_cfg):
    """fp32 2-layer model, head 64, with the zero-initialised projections
    and the embedding filled (every block does work), on both sides."""
    jcfg = JaxModelConfig(n_layer=2, n_embd=n_embd, vocab_size=vocab, head_size=64,
                          dtype="float32", param_dtype="float32")
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    params["emb"] = jnp.asarray(rng.normal(size=params["emb"].shape) * emb_scale, jnp.float32)
    sd = jax_params_to_state_dict(params, jcfg)
    cfg = sniff_model_config(sd, **{"dtype": "float32", **torch_cfg})
    return jcfg, params, load_state_dict_into(RWKV(cfg, device="cpu"), sd)


@pytest.fixture(scope="module")
def pair():
    return _setup()


def _tokens(B=3, T=16, seed=1):
    """Ragged rows: an emb terminator then pads, an emb at the end, a short
    row, and a few mask tokens."""
    t = np.random.default_rng(seed).integers(4, VOCAB, size=(B, T)).astype(np.int32)
    t[0, 10], t[0, 11:] = 1, 0
    t[1, -1] = 1
    t[2, 3], t[2, 4:] = 1, 0
    t[0, 2] = t[1, 7] = 3
    return t


def _tt(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_sequence_lengths_match_jax():
    t = _tokens()
    got = bi.sequence_lengths(_tt(t))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(jbi.sequence_lengths(jnp.asarray(t))).tolist() == [10, 15, 3]
    # every token that is neither pad nor emb counts, wherever it stands
    odd = np.array([[5, 0, 6, 1, 7, 3]], np.int32)
    assert bi.sequence_lengths(_tt(odd)).tolist() == [4]
    assert bi.sequence_lengths(_tt(odd), emb_id=None).tolist() == [5]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ragged", [False, True])
def test_bi_time_mix_matches_jax(pair, mode, ragged):
    jcfg, params, model = pair
    x = np.random.default_rng(2).standard_normal((3, 16, 128)).astype(np.float32)
    lengths = [0, 1, 11] if ragged else None
    want = jbi.bi_time_mix(params["blocks"][1]["att"], jcfg, jnp.asarray(x),
                           None if lengths is None else jnp.asarray(lengths, jnp.int32), mode=mode)
    with torch.no_grad():
        got = bi.bi_time_mix(model.blocks[1].att, torch.from_numpy(x),
                             None if lengths is None else torch.tensor(lengths), mode=mode)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_encoder_forward_and_encode_sentence_match_jax(pair, mode):
    jcfg, params, model = pair
    t = _tokens()
    with torch.no_grad():
        hidden = bi.encoder_forward(model, _tt(t), mode=mode)
        plain = bi.encoder_forward(model, _tt(t), mode=mode, reference=True)
        sent = bi.encode_sentence(model, _tt(t), mode=mode)
    assert hidden.dtype == torch.float32 and hidden.shape == (3, 16, 128)
    _close(hidden, jbi.encoder_forward(params, jcfg, jnp.asarray(t), mode=mode), 1e-4, "hidden")
    _close(plain, hidden.numpy(), 1e-6, "plain route")
    _close(sent, jbi.encode_sentence(params, jcfg, jnp.asarray(t), mode=mode), 1e-4, "sentence")
    assert torch.equal(sent[0], hidden[0, 10]) and torch.equal(sent[1], hidden[1, 15])


@pytest.mark.parametrize("mode", MODES)
def test_encoder_uses_future_context_and_padding_does_not_leak(pair, mode):
    _, _, model = pair
    t = _tokens()
    with torch.no_grad():
        h0 = bi.encoder_forward(model, _tt(t), mode=mode)
        t2 = t.copy()
        t2[1, 12] = 50                       # a FUTURE token of row 1's prefix
        h1 = bi.encoder_forward(model, _tt(t2), mode=mode)
        t3 = np.concatenate([t, np.zeros((3, 4), t.dtype)], axis=1)   # more pads
        h2 = bi.encoder_forward(model, _tt(t3), mode=mode)
    assert not np.allclose(h0[1, 0].numpy(), h1[1, 0].numpy())
    np.testing.assert_allclose(h0[0].numpy(), h1[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(h0[0, :11].numpy(), h2[0, :11].numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h0[1].numpy(), h2[1, :16].numpy(), rtol=1e-4, atol=1e-5)


def test_remat_gives_the_same_gradients(pair):
    _, _, model = pair
    t = _tt(_tokens())
    grads = []
    for remat in (True, False):
        model.zero_grad()
        bi.encoder_forward(model, t, mode="fused", remat=remat).square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None})
    assert sorted(grads[0]) == sorted(grads[1]) and len(grads[0]) > 40
    assert all(torch.equal(grads[0][n], grads[1][n]) for n in grads[0])
    model.zero_grad()


def _decoder_pair(jcfg, seed):
    dec = jbi.init_one_layer_decoder(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for tree, name in ((dec["att"], "output"), (dec["ffn"], "value"), (dec["ffn"], "receptance")):
        shape = tree[name].shape
        tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    return dec


def test_mae_forward_and_the_decoder_bridge_match_jax(pair):
    jcfg, params, model = pair
    dec = _decoder_pair(jcfg, 3)
    decoder = one_layer_decoder_from_jax(dec, model.cfg)
    assert decoder.head.weight.shape == (VOCAB, 128)
    np.testing.assert_array_equal(decoder.att.key.weight.detach().numpy(),
                                  np.asarray(dec["att"]["key"]).T)
    enc_ids, dec_ids = _tokens(seed=4), _tokens(seed=5)
    want = jbi.mae_forward({**params, "onelayer_decoder": dec}, jcfg, jnp.asarray(enc_ids),
                           jnp.asarray(dec_ids))
    model.onelayer_decoder = decoder
    try:
        with torch.no_grad():
            got = bi.mae_forward(model, _tt(enc_ids), _tt(dec_ids))
            alone = bi.mae_forward(model, _tt(enc_ids))
    finally:
        model.onelayer_decoder = None
    assert sorted(got) == sorted(want) and sorted(alone) == ["encoder_logits", "seq_emb"]
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        _close(got[key], want[key], 1e-4, key)
    bow = np.random.default_rng(6).random((3, VOCAB)).astype(np.float32)
    bow /= bow.sum(-1, keepdims=True)
    np.testing.assert_allclose(
        float(bi.dupmae_bow_loss(got["ot_logits"], torch.from_numpy(bow))),
        float(jbi.dupmae_bow_loss(want["ot_logits"], jnp.asarray(bow))), rtol=1e-5)


def test_init_one_layer_decoder_is_seeded(pair):
    jcfg, _, model = pair
    cfg = model.cfg
    a = bi.init_one_layer_decoder(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    b = bi.init_one_layer_decoder(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    bridged = one_layer_decoder_from_jax(_decoder_pair(jcfg, 0), cfg)
    assert sorted(a.state_dict()) == sorted(bridged.state_dict())
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(), b.state_dict().values()))
    assert float(a.att.key.weight.abs().max()) > 0 and float(a.att.output.weight.abs().max()) == 0
    assert torch.equal(a.ln_out.weight, torch.ones(128))
    # layer 0's schedule, as the JAX initialiser's
    np.testing.assert_allclose(a.att.time_decay.detach().numpy().reshape(-1),
                               np.asarray(_decoder_pair(jcfg, 0)["att"]["time_decay"]), rtol=1e-6)


def test_bi_streaming_matches_jax_over_three_chunks(pair):
    jcfg, params, model = pair
    t = np.random.default_rng(8).integers(4, VOCAB, size=(2, 24)).astype(np.int32)
    t[:, -1] = 1
    jstate = state = None
    for c in range(3):
        chunk, last = t[:, 8 * c: 8 * c + 8], c == 2
        jh, jstate = jbi.bi_streaming_forward(params, jcfg, jnp.asarray(chunk), jstate,
                                              is_last_chunk=last)
        with torch.no_grad():
            h, state = bi.bi_streaming_forward(model, _tt(chunk), state, is_last_chunk=last)
        _close(h, jh, 2e-5, f"hidden {c}")
        assert state["wkv"].shape == (2, 2, 2, 64, 64)
        for key in ("wkv", "wkv_rev"):
            _close(state[key], jax_unpack_wkv(jstate[key], 64), 2e-5, f"{key} {c}")
        for key in ("att_shift", "ffn_shift"):
            _close(state[key], jstate[key], 2e-5, f"{key} {c}")
    assert float(state["wkv_rev"].abs().max()) > 0
    with torch.no_grad():
        got = bi.embed_mae_streaming(model, _tt(t[:, 2:]), chunk_ctx=8)     # T = 22: padded
    _close(got, jbi.embed_mae_streaming(params, jcfg, jnp.asarray(t[:, 2:]), chunk_ctx=8), 2e-5)


def test_chunk_reverse_keeps_the_last_token_on_the_last_chunk():
    x = torch.arange(5.0)[None, :, None]
    assert bi._chunk_reverse(x, False)[0, :, 0].tolist() == [4, 3, 2, 1, 0]
    assert bi._chunk_reverse(x, True)[0, :, 0].tolist() == [3, 2, 1, 0, 4]


def test_mlm_logits_match_jax(pair):
    jcfg, params, model = pair
    hidden = np.random.default_rng(9).standard_normal((2, 5, 128)).astype(np.float32)
    got = mlm_logits(model, torch.from_numpy(hidden))
    assert got.dtype == torch.float32
    _close(got, jax_mlm_logits(params, jcfg, jnp.asarray(hidden)), 1e-6, "tied")
    head = np.random.default_rng(10).standard_normal((128, 7)).astype(np.float32)
    _close(mlm_logits(model, torch.from_numpy(hidden), share_emb=False, lm_head=torch.from_numpy(head)),
           jax_mlm_logits(params, jcfg, jnp.asarray(hidden), share_emb=False,
                          lm_head=jnp.asarray(head)), 1e-6, "separate head")
    with pytest.raises(ValueError):
        mlm_logits(model, torch.from_numpy(hidden), share_emb=False)


def test_equal_dtypes_make_every_cast_the_same_tensor(pair):
    """With param_dtype == dtype (serving, LoRA) the casts that fp32 master
    weights need return the parameter itself: no copy, no launch."""
    _, _, model = pair
    cfg = model.cfg
    assert cfg.param_dtype == cfg.dtype == "float32" and cfg.params_dtype is torch.float32
    att, ffn = model.blocks[0].att, model.blocks[0].ffn
    for p in (att.key.weight, att.time_maa_x, att.time_maa_w1, ffn.time_maa_k, model.emb.weight,
              model.ln_out.weight):
        assert p.to(cfg.compute_dtype) is p
    looked_up = torch.nn.functional.embedding(_tt(_tokens()), model.emb.weight)
    assert looked_up.to(cfg.compute_dtype) is looked_up
    assert sniff_model_config(model.state_dict()).param_dtype == "bfloat16"


@pytest.mark.parametrize("mode", MODES)
def test_bf16_compute_over_fp32_masters_matches_jax(mode):
    jcfg, params, model = _setup(seed=11, dtype="bfloat16", param_dtype="float32")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    jcfg16 = JaxModelConfig(n_layer=2, n_embd=128, vocab_size=VOCAB, head_size=64,
                            dtype="bfloat16", param_dtype="float32")
    t = _tokens()
    with torch.no_grad():
        got = bi.encoder_forward(model, _tt(t), mode=mode)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jbi.encoder_forward(params, jcfg16, jnp.asarray(t), mode=mode).astype(jnp.float32))
    _close(got, want, 2e-2)


@pytest.fixture(scope="module")
def fill_mask_pair():
    """A 2-layer, n_embd 64 encoder with the world vocabulary's size behind
    both packages' services. The embedding is small enough that no candidate
    takes nearly all the mass: near p = 1 a probability moves by the
    logits' own rounding."""
    jcfg, params, model = _setup(seed=12, vocab=65536, n_embd=64, emb_scale=0.05)
    service = ServingService(encoder=model, tokenizer=WorldTokenizer())
    jservice = JaxServingService(encoder_params=params, encoder_cfg=jcfg,
                                 tokenizer=JaxWorldTokenizer())
    return service, jservice


@pytest.mark.parametrize("text,kw", [
    ("The capital of France is [MASK].", {}),
    ("[MASK] 向量 [MASK] retrieval and [MASK]", {"top_k": 4, "cumulative_prob": 0.5}),
    ("no mask here", {}),
])
def test_fill_mask_matches_jax(fill_mask_pair, text, kw):
    service, jservice = fill_mask_pair
    got = service.handle("/fill_mask", {"text": text, **kw})
    want = jservice.fill_mask(text, **kw)
    assert len(got["masks"]) == len(want["masks"]) == text.count("[MASK]")
    for cands, jcands in zip(got["masks"], want["masks"]):
        assert [c["token_id"] for c in cands] == [c["token_id"] for c in jcands]
        assert [c["token"] for c in cands] == [c["token"] for c in jcands]
        np.testing.assert_allclose([c["prob"] for c in cands], [c["prob"] for c in jcands],
                                   rtol=0, atol=1e-5)
        probs = [c["prob"] for c in cands]
        assert probs == sorted(probs, reverse=True) and len(cands) <= kw.get("top_k", 10)
    assert service.fill_mask(text, reference=True, **kw) == got


def test_fill_mask_route_errors(fill_mask_pair):
    service, _ = fill_mask_pair
    assert service.routes == {"/stats", "/fill_mask"}
    for route in ("/generate", "/embed"):
        with pytest.raises(UnknownRoute):
            service.handle(route, {"prompt": "x", "texts": ["x"]})
    with pytest.raises(UnknownRoute):
        ServingService().handle("/fill_mask", {"text": "a [MASK]"})
    for payload in ({}, {"text": 3}, {"text": "a [MASK]", "top_k": "many"}):
        with pytest.raises(BadRequest):
            service.handle("/fill_mask", payload)
    with pytest.raises(ValueError):
        ServingService(encoder=service.encoder)
    assert service.stats()["requests"]["/fill_mask"] >= 3
