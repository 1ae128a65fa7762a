"""TBPTT (``tbptt_loss_fn``, ``sft --train-type full --chunk-ctx``) and the
remat policies (``--grad-checkpoint dots|dots_nobatch``) on the CPU, the
kernels' plain versions, against the JAX package on the same numpy-seeded
weights and batches.

Tolerances (those of tests/test_torch_train.py): loss and gradients within
1e-4 of the largest |JAX value|. The TBPTT invariant: the JAX TBPTT is not
truncated (gradients flow through every chunk), so its loss is the
full-sequence ``causal_lm_loss(..., l2_wrap=False)`` and its gradients that
loss's: on each side, the loss at rtol 1e-5 and every gradient within 1e-4
of its largest value (the chunked forward sums in another order). The remat
policies give gradients bit-equal to remat on and off (the saved products
are the same numbers the recompute would give).
"""
import collections
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.train.losses import causal_lm_loss as jax_causal_lm_loss
from rwkv_lm_ext_tpu.train.loop import tbptt_loss_fn as jax_tbptt_loss_fn
from rwkv_lm_ext_tpu_torch.adapters.lora import LoraConfig, apply_lora, init_lora_params
from rwkv_lm_ext_tpu_torch.config import TrainConfig
from rwkv_lm_ext_tpu_torch.train.losses import causal_lm_loss
from rwkv_lm_ext_tpu_torch.train.loop import make_train_step, sft_loss_fn, tbptt_loss_fn
from rwkv_lm_ext_tpu_torch.utils.remat import POLICIES, normalize_remat
from torch_stack_setup import (
    _params,
    _reference_wkv,
    check_sft_against_jax,
    jwkv,
    sft_data,
    torch_model,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

aten = torch.ops.aten


def _batch(seed, B=2, T=16, vocab=1000):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, size=(B, T)).astype(np.int32)
    labels = np.full_like(ids, -100)
    labels[:, 3:-1] = ids[:, 4:]
    labels[1, 9:] = -100                 # a chunk of row 1 with no label
    return {"input_ids": ids, "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


def _port_grads(model, loss_fn):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def _jax_grads(params, cfg, loss_fn):
    with mock.patch.object(jwkv, "_resolve_backend", _reference_wkv):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), jax_params_to_state_dict(grads, cfg)


@pytest.mark.parametrize("chunk_ctx", [4, 8])
def test_tbptt_loss_and_grads_match_jax(chunk_ctx):
    """Every parameter's gradient, remat on in the port (per block, in each
    chunk) and off in JAX."""
    params, cfg = _params(0)
    batch = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want = _jax_grads(params, cfg, lambda p: jax_tbptt_loss_fn(
        p, cfg, jb, chunk_ctx=chunk_ctx, remat=False))
    model = torch_model(params, cfg)
    loss, got = _port_grads(model, lambda m: tbptt_loss_fn(m, _tb(batch), chunk_ctx=chunk_ctx,
                                                            remat=True))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert _rel(g.numpy(), want[name]) <= 1e-4, name


def test_tbptt_equals_the_full_sequence_loss_without_l2wrap():
    """The invariant on both sides: TBPTT at chunk_ctx 4 against the whole
    sequence's causal loss without L2Wrap; the carried state's gradient
    reaches the first chunk (a stale detach would drop it)."""
    params, cfg = _params(1)
    batch = _batch(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_full(p):
        logits, _ = jax_rwkv_forward(p, cfg, jb["input_ids"])
        return jax_causal_lm_loss(logits, jb["labels"], l2_wrap=False)

    j_chunked = _jax_grads(params, cfg, lambda p: jax_tbptt_loss_fn(p, cfg, jb, chunk_ctx=4,
                                                                   remat=False))
    j_full = _jax_grads(params, cfg, jax_full)
    model = torch_model(params, cfg)

    def port_full(m):
        logits, _ = m(_tb(batch)["input_ids"], t1_step=False)
        return causal_lm_loss(logits, _tb(batch)["labels"], l2_wrap=False)

    p_chunked = _port_grads(model, lambda m: tbptt_loss_fn(m, _tb(batch), chunk_ctx=4, remat=False))
    p_full = _port_grads(model, port_full)
    for (loss, grads), (want_loss, want) in ((p_chunked, p_full), (j_chunked, j_full)):
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for name, g in grads.items():
            assert _rel(np.asarray(g), np.asarray(want[name])) <= 1e-4, name
    # with no label in the first chunk, only the carried state links the
    # first token (id 2, drawn nowhere else) to the loss
    ids = batch["input_ids"].copy()
    ids[0, 0] = 2
    cut = {"input_ids": ids, "labels": np.where(np.arange(16) < 4, -100, batch["labels"])}
    _, grads = _port_grads(model, lambda m: tbptt_loss_fn(m, _tb(cut), chunk_ctx=4, remat=False))
    assert grads["emb.weight"][2].abs().max() > 0


def test_tbptt_refuses_a_length_off_the_chunks():
    params, cfg = _params(2)
    with pytest.raises(ValueError, match="pad sequences to a multiple of chunk_ctx"):
        tbptt_loss_fn(torch_model(params, cfg), _tb(_batch(3, T=12)), chunk_ctx=8)


def test_make_train_step_takes_tbptt_with_chunk_ctx():
    """With no loss_fn and tc.chunk_ctx, the step's loss is tbptt_loss_fn's
    (as JAX make_train_step picks it)."""
    params, cfg = _params(3)
    model = torch_model(params, cfg)
    batch = _tb(_batch(4))
    with torch.no_grad():
        want = tbptt_loss_fn(model, batch, chunk_ctx=8).item()
        l2 = sft_loss_fn(model, batch, remat=False).item()
    step = make_train_step(model, TrainConfig(chunk_ctx=8, lr_init=1e-5, warmup_steps=0,
                                              grad_checkpoint=False))
    got = float(step(batch)["loss"])
    assert got == pytest.approx(want, rel=1e-6) and got != pytest.approx(l2, rel=1e-6)


def test_tbptt_command_matches_jax(tmp_path):
    """sft --train-type full --chunk-ctx 16 through both CLIs (SFT_DOC)."""
    check_sft_against_jax(sft_data(tmp_path), tmp_path,
                          ["--train-type", "full", "--chunk-ctx", "16"])


# ---------------------------------------------------------------------------
# The remat policies
# ---------------------------------------------------------------------------

def test_normalize_remat_spellings():
    assert [normalize_remat(s) for s in ("on", "full", True, "off", "none", False, None)] == \
        [True, True, True, False, False, False, False]
    assert normalize_remat("dots") == "dots" and normalize_remat("DOTS_NOBATCH") == "dots_nobatch"
    with pytest.raises(ValueError, match="unknown remat spec"):
        normalize_remat("dots_saveable")


class _Count(TorchDispatchMode):
    """aten operations by name while the mode is on."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def test_the_products_reach_the_policies_ops():
    """utils/remat.py's list: F.linear and x @ W on a (B, T, C) input reach
    aten.mm, with a bias aten.addmm, torch.bmm and the batched einsum
    aten.bmm, the CPU's int8 product an int32 aten.mm."""
    x, w = torch.randn(2, 3, 8), torch.randn(5, 8)
    cases = {
        "linear": (lambda: F.linear(x, w), aten.mm.default),
        "linear with bias": (lambda: F.linear(x, w, torch.randn(5)), aten.addmm.default),
        "matmul": (lambda: x @ w.t(), aten.mm.default),
        "bmm": (lambda: torch.bmm(x, torch.randn(2, 8, 4)), aten.bmm.default),
        "einsum": (lambda: torch.einsum("btfd,fdc->fbtc", x.reshape(2, 3, 2, 4),
                                        torch.randn(2, 4, 6)), aten.bmm.default),
        "int8": (lambda: x.to(torch.int32) @ w.t().to(torch.int32), aten.mm.default),
    }
    for name, (fn, op) in cases.items():
        with _Count() as c:
            fn()
        products = {k for k in c.ops if k in POLICIES["dots"]}
        assert products == {op}, (name, c.ops)
    assert aten._int_mm.default in POLICIES["dots_nobatch"]
    assert aten.bmm.default in POLICIES["dots"] and aten.bmm.default not in POLICIES["dots_nobatch"]


def test_policies_give_the_gradients_of_on_and_off_and_recompute_no_saved_product():
    """LoRA over the 2-layer model: the gradients under dots and
    dots_nobatch are bit-equal to remat on's and off's. Counting the aten
    products of the backward: on recomputes every product of the blocks;
    dots recomputes none (its backward runs off's products); dots_nobatch
    recomputes the batched ones only."""
    params, cfg = _params(4)
    model = torch_model(params, cfg)
    lc = LoraConfig(r=4, alpha=16.0)
    adapter = init_lora_params(model, lc, torch.Generator().manual_seed(0))
    for ab in adapter.values():
        ab["B"].normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    apply_lora(model, lc, adapter)
    batch = _tb(_batch(5))
    grads, bwd, fwd = {}, {}, {}
    for remat in (False, True, "dots", "dots_nobatch"):
        model.zero_grad(set_to_none=True)
        with _Count() as f:
            loss = sft_loss_fn(model, batch, remat=remat)
        with _Count() as b:
            loss.backward()
        grads[remat] = [p.grad.clone() for p in model.parameters() if p.requires_grad]
        fwd[remat] = (f.ops[aten.mm.default], f.ops[aten.bmm.default])
        bwd[remat] = (b.ops[aten.mm.default], b.ops[aten.bmm.default])
    for remat in (True, "dots", "dots_nobatch"):
        assert all(torch.equal(a, b) for a, b in zip(grads[remat], grads[False])), remat
        assert fwd[remat] == fwd[False]
    (mm_off, bmm_off), (mm_on, bmm_on) = bwd[False], bwd[True]
    assert mm_on > mm_off and bmm_on > bmm_off       # the recompute's products
    assert bwd["dots"] == (mm_off, bmm_off)
    assert bwd["dots_nobatch"] == (mm_off, bmm_on)


@pytest.mark.parametrize("policy", ["dots", "dots_nobatch"])
def test_policy_command_matches_jax(tmp_path, policy):
    """sft --grad-checkpoint dots|dots_nobatch through both CLIs: the JAX
    command under its checkpoint policy, the port under its selective
    checkpoint (SFT_DOC, with the policy in place of remat off)."""
    check_sft_against_jax(sft_data(tmp_path), tmp_path, ["--train-type", "lora",
                                                         "--grad-checkpoint", policy])
