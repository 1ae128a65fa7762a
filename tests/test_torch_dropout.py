"""Dropout in the port's forward (models.rwkv ``Dropout``) and ``simcse
--dropout-noise`` (CPU, the kernels' plain versions) against the JAX package.

JAX's masks come from ``jax.random`` and cannot be drawn in torch, so the
comparisons hand the port JAX's own masks through ``Dropout(mask_fn=)``:
``jax_masks`` draws them on JAX's key splits (rwkv_forward's ``n_layer + 1``
keys, the embeddings' first, then two a block for the attention and channel
mix outputs). The model is the shared RWKV-6 fixture
(tests/torch_stack_setup.py: 2 layers, C=128, fp32); the JAX side runs its
sequential reference WKV.

Tolerances: rate 0 is bit-equal to no dropout (forward and gradient); under
JAX's masks the hidden states and the gradient of every parameter within
1e-5 of their largest value; the kept share within a binomial 5 sigma of
1 - p and every kept value x / (1 - p) exactly; the simcse loss under JAX's
masks at rtol 1e-5 of JAX's loss closure.
"""
import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.models.heads import first_token_position as jax_first_token_position
from rwkv_lm_ext_tpu.models.heads import pool_hidden as jax_pool_hidden
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.train.losses import simcse_loss as jax_simcse_loss
from rwkv_lm_ext_tpu_torch.checkpoint.convert import load_state_dict_into, save_rwkv_checkpoint
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV, Dropout, drop
from rwkv_lm_ext_tpu_torch.train import cli as pcli
from rwkv_lm_ext_tpu_torch.train.loop import simcse_loss_fn
from torch_stack_setup import _params, _tokenizer, torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers

P = 0.1
TOKENS = np.random.default_rng(3).integers(3, 1000, size=(2, 12))


def jax_masks(rng, n_layer: int, shape):
    """{(site, layer): keep mask} as JAX's rwkv_forward draws them from
    ``rng`` at rate P."""
    keys = jax.random.split(rng, n_layer + 1)
    masks = {("emb", None): np.asarray(jax.random.bernoulli(keys[0], 1.0 - P, shape))}
    for i in range(n_layer):
        att, ffn = jax.random.split(keys[i + 1], 2)
        masks[("att", i)] = np.asarray(jax.random.bernoulli(att, 1.0 - P, shape))
        masks[("ffn", i)] = np.asarray(jax.random.bernoulli(ffn, 1.0 - P, shape))
    return masks


class ViewMasks:
    """A mask_fn serving the masks of one JAX key per view, in call order:
    a view starts at its embeddings' site."""

    def __init__(self, rngs, n_layer, shape):
        self.views = [jax_masks(r, n_layer, shape) for r in rngs]
        self.view = -1

    def __call__(self, site, layer, shape):
        if site == "emb":
            self.view += 1
        mask = self.views[self.view][(site, layer)]
        assert mask.shape == shape
        return torch.from_numpy(mask.copy())


def _jcfg(jcfg):
    return dataclasses.replace(jcfg, dropout=P)


def test_rate_zero_is_bit_equal_to_no_dropout():
    params, jcfg = _params(0)
    model = torch_model(params, jcfg)
    tokens = torch.from_numpy(TOKENS)
    outs = []
    for dropout in (None, Dropout(0.0, torch.Generator().manual_seed(0))):
        model.zero_grad()
        hidden, _ = model(tokens, return_hidden=True, return_logits=False, dropout=dropout)
        hidden.float().square().sum().backward()
        outs.append([hidden.detach()] + [p.grad.clone() for p in model.parameters()
                                         if p.grad is not None])
    assert len(outs[0]) == len(outs[1]) > 2
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_forward_and_gradient_under_jax_masks_match_jax():
    params, jcfg = _params(0)
    jcfg = _jcfg(jcfg)
    model = torch_model(params, jcfg)
    rng = jax.random.PRNGKey(7)
    B, T = TOKENS.shape
    cot = np.random.default_rng(4).normal(size=(B, T, jcfg.n_embd)).astype(np.float32)

    def jax_loss(p):
        hidden, _ = jax_rwkv_forward(p, jcfg, jnp.asarray(TOKENS), dropout_rng=rng,
                                     return_hidden=True, return_logits=False,
                                     wkv_backend="reference")
        return jnp.sum(hidden * cot), hidden

    (_, want), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    dropout = Dropout(P, mask_fn=ViewMasks([rng], jcfg.n_layer, (B, T, jcfg.n_embd)))
    hidden, _ = model(torch.from_numpy(TOKENS), return_hidden=True, return_logits=False,
                      dropout=dropout)
    (hidden * torch.from_numpy(cot)).sum().backward()
    want = np.asarray(want)
    assert np.abs(hidden.detach().numpy() - want).max() <= 1e-5 * np.abs(want).max()
    # JAX's gradients in the port's names, as the weights were carried
    flat = jax_params_to_state_dict(jgrads, jcfg)
    for name, p in model.named_parameters():
        g = np.asarray(flat[name], np.float32).reshape(p.shape)
        got = np.zeros_like(g) if p.grad is None else p.grad.numpy()   # the head: unused
        err = np.abs(got - g).max()
        assert err <= 1e-5 * max(np.abs(g).max(), 1e-30), (name, err)


def test_kept_share_and_scaling():
    dropout = Dropout(P, torch.Generator().manual_seed(1))
    shape = (8, 64, 64)
    keep = dropout.keep("att", 0, shape, "cpu")
    n = keep.numel()
    sigma = (n * P * (1 - P)) ** 0.5
    assert abs(int(keep.sum()) - n * (1 - P)) <= 5 * sigma
    x = torch.randn(shape)
    y = drop(x, P, keep)
    assert torch.equal(y[keep], x[keep] / (1 - P)) and not y[~keep].any()
    # each site and each call draws masks of its own
    assert not torch.equal(keep, dropout.keep("att", 0, shape, "cpu"))


def test_simcse_loss_under_jax_masks_matches_the_jax_closure():
    """The JAX command's closure (train/cli.py:1147-1164): one key folded
    from the seed and the batch, split into the two views' keys."""
    params, jcfg = _params(0)
    jcfg = _jcfg(jcfg)
    model = torch_model(params, jcfg)
    rows = np.random.default_rng(5).integers(3, 1000, size=(3, 10))
    a = np.concatenate([rows, np.ones((3, 1), np.int64), np.zeros((3, 2), np.int64)], 1)
    batch = {"a": a, "b": a.copy()}
    seed = 3
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.sum(jnp.asarray(a)).astype(jnp.uint32))
    r1, r2 = jax.random.split(rng)

    def embed(tokens, key):
        hidden, _ = jax_rwkv_forward(params, jcfg, tokens, dropout_rng=key, return_hidden=True,
                                     return_logits=False, wkv_backend="reference")
        return jax_pool_hidden(hidden, jax_first_token_position(tokens, 1), "weightedmean")

    want = jax_simcse_loss(embed(jnp.asarray(a), r1), embed(jnp.asarray(a), r2), temperature=0.05)
    dropout = Dropout(P, mask_fn=ViewMasks([r1, r2], jcfg.n_layer, a.shape + (jcfg.n_embd,)))
    got = simcse_loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, remat=False,
                         dropout=dropout)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    # the masks moved the loss: without them the two views are one
    same = simcse_loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, remat=False)
    assert abs(float(same) - float(got)) > 1e-3


def test_simcse_dropout_noise_trains_on_the_cpu(tmp_path, capsys):
    """Three steps of ``simcse --dropout-noise`` on {"text"} rows through
    the CLI: finite losses, the model file, and two views of one text that
    differ under the command's dropout."""
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=32)
    gen = torch.Generator().manual_seed(0)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen) * 0.5 / sd[key].shape[1] ** 0.5
    model = load_state_dict_into(RWKV(cfg, device="cpu"), sd)
    save_rwkv_checkpoint(model, str(tmp_path / "tiny.pth"))
    words = "cats dogs birds fish trees rivers stones clouds".split()
    with open(tmp_path / "text.jsonl", "w") as f:
        for i in range(12):
            f.write(json.dumps({"text": " ".join(words[(i + j) % 8] for j in range(4 + i % 3))})
                    + "\n")
    argv = ["simcse", "--dropout-noise", "--model", str(tmp_path / "tiny.pth"), "--train-data",
            str(tmp_path / "text.jsonl"), "--output-dir", str(tmp_path / "out"), "--platform",
            "cpu", "--micro-bsz", "1", "--max-steps", "3", "--log-every", "1",
            "--warmup-steps", "0"]
    capsys.readouterr()
    seen = {}
    real = pcli.simcse_loss_fn

    def spy(model_, batch, **kw):
        seen.setdefault("dropout", kw["dropout"])
        return real(model_, batch, **kw)

    with mock.patch.object(pcli, "WorldTokenizer", _tokenizer(pcli.WorldTokenizer)), \
            mock.patch.object(pcli, "simcse_loss_fn", spy):
        pcli.main(argv)
    out = capsys.readouterr().out
    losses = [json.loads(ln.split(": ", 1)[1])["loss"] for ln in out.splitlines()
              if ln.startswith("step ")]
    assert len(losses) == 3 and np.isfinite(losses).all(), out
    assert (tmp_path / "out" / "simcse-step3.pth").exists()
    dropout = seen["dropout"]
    assert dropout is not None and dropout.rate == P
    tokens = torch.from_numpy(np.array([[5, 9, 23, 40, 1, 0]]))
    with torch.no_grad():
        a, _ = model(tokens, return_hidden=True, return_logits=False, dropout=dropout)
        b, _ = model(tokens, return_hidden=True, return_logits=False, dropout=dropout)
    assert not torch.equal(a, b)
