"""The port's sequence-level losses, task heads and contrastive collators
(CPU, the kernels' plain versions) against the JAX package on the same
seeded numpy inputs and the same weights (tests/torch_stack_setup.py: 2
layers, n_embd 128, fp32); and the bidirectional encoder's trainers
(encoder-biencoder, encoder-crossencoder) and ``mae --uni`` against the JAX
commands through the shared harness (torch_stack_setup.TRAINER_DOC).

Tolerances: every loss and its input gradient at rtol 1e-5; the heads
within 1e-5 of the largest |JAX value| plus 1e-6 (a score is a sum over C
with cancellation: fp32 rounding of the hidden states, ~1e-6 of their size,
moves a small score by more than 1e-5 of itself), the JAX side on its
sequential reference WKV
(``wkv_backend="reference"``, the recurrence the port's plain version runs;
its chunked factoring differs by up to 1.5e-5 relative); the collators
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.data import collators as jcollators
from rwkv_lm_ext_tpu.models import heads as jheads
from rwkv_lm_ext_tpu.train import losses as jlosses
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    embedding_head_from_jax,
    instructor_head_from_jax,
    score_head_from_jax,
)
from rwkv_lm_ext_tpu_torch.data import collators
from rwkv_lm_ext_tpu_torch.models import heads
from rwkv_lm_ext_tpu_torch.models.rwkv import Norm
from rwkv_lm_ext_tpu_torch.train import losses
from rwkv_lm_ext_tpu_torch.train.optim import decay_mask, lr_scale_labels
from torch_stack_setup import (
    TRAINER_CASES,
    check_trainer_against_jax,
    contrastive_data,
    jax_params,
    torch_model,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

B, D = 6, 24
REF = "reference"    # the JAX package's sequential WKV


def _emb(rng, n=B):
    return rng.standard_normal((n, D)).astype(np.float32)


# (name, port function, JAX function, how many (B, D) inputs, keywords)
LOSSES = [
    ("infonce", losses.in_batch_infonce, jlosses.in_batch_infonce, 2, {}),
    ("infonce_negatives", losses.in_batch_infonce, jlosses.in_batch_infonce, 3, {}),
    ("cosent", losses.cosent_loss, jlosses.cosent_loss, 2, {}),
    ("cosent_negatives", losses.cosent_loss, jlosses.cosent_loss, 3, {}),
    ("symmetric", losses.symmetric_infonce, jlosses.symmetric_infonce, 2, {}),
    ("symmetric_negatives", losses.symmetric_infonce, jlosses.symmetric_infonce, 3,
     {"temperature": 0.1}),
    ("simcse", losses.simcse_loss, jlosses.simcse_loss, 2, {"temperature": 0.07}),
]


@pytest.mark.parametrize("name,fn,jfn,n_in,kw", LOSSES, ids=[x[0] for x in LOSSES])
def test_embedding_losses_and_their_gradients_match_jax(name, fn, jfn, n_in, kw):
    rng = np.random.default_rng(len(name))
    xs = [_emb(rng) for _ in range(n_in)]
    want, want_g = jax.value_and_grad(lambda *a: jfn(*a, **kw), argnums=tuple(range(n_in)))(
        *[jnp.asarray(x) for x in xs])
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    got = fn(*ts, **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)


def test_cosent_keeps_its_exact_form():
    """The -1e12 mask, a zero prepended to n^2 differences, the division by
    n^2 + 1: a batch whose positives all score alike gives log(1 + n^2 e^x)
    terms only for the ordered pairs."""
    q = torch.ones(2, 3)
    got = losses.cosent_loss(q, q, -q)            # positives cos 1, negatives cos -1
    # ordered pairs: negative (label -1) before positive (label 1): 2 * 2 of
    # them, each difference 20 * (-1 - 1) = -40; the zero entry adds e^0
    want = np.log(1.0 + 4 * np.exp(-40.0)) / (16 + 1)
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    np.testing.assert_allclose(
        got.item(), float(jlosses.cosent_loss(*(jnp.asarray(x.numpy()) for x in (q, q, -q)))),
        rtol=1e-6)


@pytest.mark.parametrize("groups", [4, 1])
def test_group_softmax_and_classification_losses_match_jax(groups):
    rng = np.random.default_rng(groups)
    scores = rng.standard_normal((B, groups)).astype(np.float32) * 2
    want, want_g = jax.value_and_grad(jlosses.group_softmax_loss)(jnp.asarray(scores))
    t = torch.from_numpy(scores).requires_grad_()
    got = losses.group_softmax_loss(t)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)
    # scalar scores: MSE on 0/1 labels; (B, n) scores: cross entropy
    flat = scores[:, 0]
    labels = rng.integers(0, 2, size=B).astype(np.int32)
    for s, lab in ((flat, labels), (scores, rng.integers(0, groups, size=B).astype(np.int32))):
        want = jlosses.classification_loss(jnp.asarray(s), jnp.asarray(lab))
        got = losses.classification_loss(torch.from_numpy(s), torch.from_numpy(lab))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    params, cfg = jax_params(seed=3)
    return params, cfg, torch_model(params, cfg)


def _tokens(seed, Bt=3, T=20, vocab=1000):
    """Rows of different lengths ending in the emb / cls id 1, pad 0 after;
    the last row has no 1 (position 0, as argmax of an all-zero row)."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((Bt, T), np.int32)
    for i, n in enumerate(rng.integers(4, T, size=Bt)):
        toks[i, :n] = rng.integers(3, vocab, size=n)
        if i < Bt - 1:
            toks[i, n - 1] = 1
    return toks


def _close(got, want):
    got, want = got.detach().numpy().astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    # a row without the emb id pools over zero positions: NaN in both
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    got, want = got[~nan], want[~nan]
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max() + 1e-6, (err, np.abs(want).max())


def test_classify_sequences_matches_jax(pair):
    params, cfg, model = pair
    rng = np.random.default_rng(4)
    toks = _tokens(5)
    for n in (1, 3):
        tree = {"kernel": jnp.asarray(rng.standard_normal((cfg.n_embd, n)).astype(np.float32))}
        want = jheads.classify_sequences(params, cfg, jnp.asarray(toks), tree, wkv_backend=REF)
        got = heads.classify_sequences(model, torch.from_numpy(toks).long(), score_head_from_jax(tree))
        assert got.shape == want.shape == ((3,) if n == 1 else (3, n))
        _close(got, want)


@pytest.mark.parametrize("pooling", ["weightedmean", "lasttoken", "avg"])
def test_embed_sequences_with_the_dense_head_matches_jax(pair, pooling):
    params, cfg, model = pair
    toks = _tokens(6)
    tree = jheads.init_embedding_head(jax.random.PRNGKey(7), cfg, output_dim=48)
    tree["dense"]["bias"] = jnp.asarray(np.random.default_rng(8).standard_normal(48), jnp.float32)
    want = jheads.embed_sequences(params, cfg, jnp.asarray(toks), head_params=tree,
                                  pooling_type=pooling, normalize=True, wkv_backend=REF)
    got = heads.embed_sequences(model, torch.from_numpy(toks).long(),
                                head=embedding_head_from_jax(tree), pooling_type=pooling,
                                normalize=True)
    assert got.shape == (3, 48)
    _close(got, want)


def test_instructor_embed_matches_jax(pair):
    params, cfg, model = pair
    rng = np.random.default_rng(9)
    toks = _tokens(10)
    out = 40
    tree = {"dense": {"kernel": jnp.asarray(rng.standard_normal((cfg.n_embd, out)) * 0.1, jnp.float32),
                      "bias": jnp.asarray(rng.standard_normal(out) * 0.1, jnp.float32)},
            "ln": {"scale": jnp.asarray(1 + rng.standard_normal(out) * 0.1, jnp.float32),
                   "bias": jnp.asarray(rng.standard_normal(out) * 0.1, jnp.float32)}}
    want = jheads.instructor_embed(params, cfg, jnp.asarray(toks), tree, wkv_backend=REF)
    dense, ln = instructor_head_from_jax(tree)
    got = heads.instructor_embed(model, torch.from_numpy(toks).long(), dense, ln)
    _close(got, want)


@pytest.mark.parametrize("chunk_ctx", [8, 20])
def test_embed_sequences_chunked_matches_jax(pair, chunk_ctx):
    """chunk_ctx 8 pads the 20-token rows to 24 and carries the state over
    three pieces; 20 is one piece."""
    params, cfg, model = pair
    toks = _tokens(11)
    tree = jheads.init_embedding_head(jax.random.PRNGKey(12), cfg)
    want = jheads.embed_sequences_chunked(params, cfg, jnp.asarray(toks), chunk_ctx=chunk_ctx,
                                          head_params=tree, wkv_backend=REF)
    got = heads.embed_sequences_chunked(model, torch.from_numpy(toks).long(), chunk_ctx=chunk_ctx,
                                        head=embedding_head_from_jax(tree))
    _close(got, want)
    with torch.no_grad():
        whole = heads.embed_sequences(model, torch.from_numpy(toks).long(),
                                      head=embedding_head_from_jax(tree))
    _close(got, whole)


def test_head_initialisers_and_their_optimizer_groups():
    """The heads' bounds and layouts, and what the optimizer makes of their
    names: the matrices decay, the vectors do not, all at 1x, as the JAX
    optimizer's rules give for the JAX trees."""
    params, cfg = jax_params(seed=0)
    gen = torch.Generator().manual_seed(0)
    score = heads.init_classification_head(cfg, generator=gen, num_labels=2)
    dense = heads.init_embedding_head(cfg, generator=gen, output_dim=32)
    ln = heads.init_layer_norm(32, device="cpu")
    lim = 1 / np.sqrt(cfg.n_embd)
    assert score.weight.shape == (2, cfg.n_embd) and dense.weight.shape == (32, cfg.n_embd)
    assert max(float(h.weight.detach().abs().max()) for h in (score, dense)) <= lim
    assert not dense.bias.any() and bool((ln.weight == 1).all()) and not ln.bias.any()
    named = [("score.weight", score.weight), ("dense.weight", dense.weight),
             ("dense.bias", dense.bias), ("ln_dense.weight", ln.weight), ("ln_dense.bias", ln.bias)]
    jtree = {"score": {"kernel": jnp.zeros((cfg.n_embd, 2))},
             "dense": {"kernel": jnp.zeros((cfg.n_embd, 32)), "bias": jnp.zeros(32)},
             "ln": {"scale": jnp.zeros(32), "bias": jnp.zeros(32)}}
    from rwkv_lm_ext_tpu.train.optim import decay_mask as jdecay
    from rwkv_lm_ext_tpu.train.optim import lr_scale_labels as jlabels
    jd, jl = jdecay(jtree), jlabels(jtree)
    want_decay = {"score.weight": jd["score"]["kernel"], "dense.weight": jd["dense"]["kernel"],
                  "dense.bias": jd["dense"]["bias"], "ln_dense.weight": jd["ln"]["scale"],
                  "ln_dense.bias": jd["ln"]["bias"]}
    assert decay_mask(named) == {k: bool(v) for k, v in want_decay.items()}
    assert set(lr_scale_labels(named).values()) == {"1x"} == set(jax.tree_util.tree_leaves(jl))
    assert isinstance(ln, Norm)


def test_triplet_collate_matches_jax():
    rng = np.random.default_rng(13)

    def ids(n):
        return rng.integers(3, 500, size=n).tolist()

    # candidates lists on positive and negative: both packages pick the same
    examples = [{"query": ids(5 + i), "positive": [ids(3), ids(9), ids(4)],
                 "negative": [ids(12), ids(2)]} for i in range(4)]
    for fixed_len in (8, 16):
        got = collators.triplet_collate(examples, fixed_len)
        want = jcollators.triplet_collate(examples, fixed_len)
        assert sorted(got) == sorted(want) == ["negative", "positive", "query"]
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    plain = [{"query": ids(4), "positive": ids(6)} for _ in range(3)]
    got, want = collators.triplet_collate(plain, 8), jcollators.triplet_collate(plain, 8)
    assert sorted(got) == sorted(want) == ["positive", "query"]
    np.testing.assert_array_equal(got["positive"], want["positive"])


def test_cross_encoder_collate_matches_jax():
    rng = np.random.default_rng(14)
    examples = [{"query": rng.integers(3, 500, size=q).tolist(),
                 "document": rng.integers(3, 500, size=d).tolist(), "label": i % 2}
                for i, (q, d) in enumerate([(3, 4), (5, 20), (30, 30), (2, 0)])]
    examples.append({"query": [7, 8], "document": [9]})          # no label: 1
    for fixed_len in (12, 64):
        got = collators.cross_encoder_collate(examples, fixed_len)
        want = jcollators.cross_encoder_collate(examples, fixed_len)
        for k in ("input_ids", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert list(got["labels"]) == [0, 1, 0, 1, 1]


ENCODERS = [c for c in TRAINER_CASES if c[0] in ("encoder-biencoder", "encoder-crossencoder", "mae")]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return contrastive_data(tmp_path_factory.mktemp("contrastive_data"))


@pytest.mark.parametrize("command,fmt,extra", ENCODERS,
                         ids=[" ".join([c] + e) for c, _, e in ENCODERS])
def test_encoder_trainer_matches_the_jax_command(data, tmp_path, command, fmt, extra):
    check_trainer_against_jax(data, tmp_path, command, fmt, extra)
