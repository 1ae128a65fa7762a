"""PiSSA, merged LoRA application, slot-LoRA training, LISA, the HF-peft
keys and the ``sft`` train types through the command's step (CPU, the
kernels' plain versions), against the JAX package on the same numpy-seeded
weights and batches; the command line end to end is
tests/test_torch_peft_cli.py.

Tolerances (those of tests/test_torch_train.py): loss and gradients within
1e-4 of the largest |JAX value|; parameters after three steps within 1e-5
(through the ``sft`` command, the harness of tests/torch_stack_setup.py,
SFT_DOC). PiSSA's randomized SVD draws other numbers than JAX's, so it is
held on weights whose singular values are 2^-i, where both converge to the
same top-r subspace: A @ B, the residual and the top-r singular values
within 1e-5 of their largest value. merge_pissa gives back the original
weight within 1e-5 of its largest value.
"""
import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.adapters import LoraConfig as JaxLoraConfig
from rwkv_lm_ext_tpu.adapters import merge_lora as jax_merge_lora
from rwkv_lm_ext_tpu.adapters import init_lora_params as jax_init_lora_params
from rwkv_lm_ext_tpu.adapters import pissa_init as jax_pissa_init
from rwkv_lm_ext_tpu.adapters.lora import lora_state_dict_to_tree as jax_lora_state_dict_to_tree
from rwkv_lm_ext_tpu.adapters.lora import merge_pissa as jax_merge_pissa
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.config import TrainConfig as JaxTrainConfig
from rwkv_lm_ext_tpu.train.callbacks import LisaSchedule as JaxLisaSchedule
from rwkv_lm_ext_tpu.train.loop import make_train_step as jax_make_train_step
from rwkv_lm_ext_tpu.train.loop import sft_loss_fn as jax_sft_loss_fn
from rwkv_lm_ext_tpu_torch.adapters.lora import (
    LoraConfig,
    LoraLinear,
    apply_lora,
    lora_state_dict_to_tree,
    merge_lora,
    merge_pissa,
    pissa_init,
)
from rwkv_lm_ext_tpu_torch.adapters.slot_lora import (
    apply_slot_stacks,
    init_slot_stacks,
    set_slot_idx,
    slot_stacks,
    split_slot_stacks,
)
from rwkv_lm_ext_tpu_torch.checkpoint.convert import lora_tree_from_jax
from rwkv_lm_ext_tpu_torch.config import TrainConfig
from rwkv_lm_ext_tpu_torch.train.callbacks import LisaSchedule
from rwkv_lm_ext_tpu_torch.train.loop import make_train_step, sft_loss_fn
from rwkv_lm_ext_tpu_torch.train.optim import apply_trainable_mask, trainable_mask
from torch_stack_setup import (
    LR,
    _reference_wkv,
    check_sft_against_jax,
    jax_params,
    jwkv,
    sft_data,
    torch_model,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

LC = LoraConfig(r=4, alpha=16.0)
JLC = JaxLoraConfig(r=4, alpha=16.0)


def _rel(got, want):
    """max |got - want| over max |want| (the absolute error where want is 0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() or 1.0)


def _batch(seed, B=2, T=16, vocab=1000):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, vocab, size=(B, T)).astype(np.int32)
    labels = np.full_like(ids, -100)
    labels[:, 3:-1] = ids[:, 4:]
    return {"input_ids": ids, "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# PiSSA
# ---------------------------------------------------------------------------

def _gapped_params(seed=0):
    """A JAX model whose adapted weights have singular values 2^-i."""
    params, cfg = jax_params(seed)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for sub in ("att", "ffn"):
            for name, w in bp[sub].items():
                if getattr(w, "ndim", 0) == 2 and name in ("receptance", "key", "value", "gate",
                                                           "output"):
                    n_in, n_out = w.shape
                    k = min(n_in, n_out)
                    U, _ = np.linalg.qr(rng.normal(size=(n_in, k)))
                    V, _ = np.linalg.qr(rng.normal(size=(n_out, k)))
                    bp[sub][name] = jnp.asarray((U * 2.0 ** -np.arange(k)) @ V.T, jnp.float32)
    return params, cfg


def test_pissa_init_converges_to_the_jax_subspace():
    params, cfg = _gapped_params()
    deflated, jad = jax.jit(lambda p: jax_pissa_init(p, JaxLoraConfig(r=4, pissa=True)))(params)
    model = torch_model(params, cfg)
    adapter, residuals = pissa_init(model, LoraConfig(r=4, pissa=True),
                                    torch.Generator().manual_seed(0))
    want_sd = jax_params_to_state_dict(deflated, cfg)
    assert sorted(adapter) == sorted(jad) and len(adapter) == 16
    for key, ab in adapter.items():
        got_ab = (ab["A"] @ ab["B"]).numpy()
        want_ab = np.asarray(jad[key]["A"] @ jad[key]["B"])
        assert _rel(got_ab, want_ab) <= 1e-5, key
        s_got = np.linalg.svd(got_ab, compute_uv=False)[:4]
        s_want = np.linalg.svd(want_ab, compute_uv=False)[:4]
        np.testing.assert_allclose(s_got, s_want, rtol=0, atol=1e-5 * s_want[0])
        np.testing.assert_allclose(s_got, 2.0 ** -np.arange(4), rtol=1e-5)
        w = model.get_submodule(key).weight.detach().numpy()
        np.testing.assert_array_equal(w, residuals[f"{key}.weight"].numpy())
        assert np.abs(w - want_sd[f"{key}.weight"]).max() <= 1e-5 * np.abs(got_ab).max()


def test_merge_pissa_gives_back_the_original_base():
    """The residual base plus the SVD init is the original weight, and
    merge_pissa of a trained adapter on the original base is the trained
    adapter merged on the residual, as JAX's merge_pissa gives it."""
    params, cfg = jax_params(seed=1)
    original = torch_model(params, cfg)
    lc = LoraConfig(r=4, pissa=True)
    residual = copy.deepcopy(original)
    init, _ = pissa_init(residual, lc, torch.Generator().manual_seed(1))
    back = merge_lora(apply_lora(copy.deepcopy(residual), lc, init))
    same = merge_pissa(copy.deepcopy(original), init, init, lc)
    rng = np.random.default_rng(2)
    trained = {k: {"A": ab["A"] + 0.01 * torch.from_numpy(rng.normal(size=ab["A"].shape)).float(),
                   "B": ab["B"] - 0.02} for k, ab in init.items()}
    got = merge_pissa(copy.deepcopy(original), trained, init, lc)
    want = merge_lora(apply_lora(copy.deepcopy(residual), lc, trained))
    jwant = jax_params_to_state_dict(jax_merge_pissa(
        params, {k: {n: jnp.asarray(v.numpy()) for n, v in ab.items()} for k, ab in trained.items()},
        {k: {n: jnp.asarray(v.numpy()) for n, v in ab.items()} for k, ab in init.items()},
        JaxLoraConfig(r=4, pissa=True)), cfg)
    for key, w in original.state_dict().items():
        for model in (back, same):
            assert _rel(model.state_dict()[key].numpy(), w.numpy()) <= 1e-5, key
        assert _rel(got.state_dict()[key].numpy(), want.state_dict()[key].numpy()) <= 1e-5, key
        assert _rel(got.state_dict()[key].numpy(), jwant[key]) <= 1e-6, key
    with pytest.raises(ValueError, match="PiSSA"):
        merge_pissa(original, init, init, LoraConfig(r=4))


def test_jax_serve_cli_config_fails_merge_pissa():
    """ROADMAP C.20, pinned: the JAX serving CLI merges --pissa-init with
    LoraConfig(r, alpha), without pissa=True, which merge_pissa asserts
    against before it reads a weight; the port's CLI gives the merge a PiSSA
    config."""
    with pytest.raises(AssertionError, match="PiSSA"):
        jax_merge_pissa({}, {}, {}, JaxLoraConfig(r=4, alpha=16.0))


def test_pissa_command_matches_jax_and_writes_init_pissa(tmp_path):
    check_sft_against_jax(sft_data(tmp_path), tmp_path, ["--train-type", "pissa"])


# ---------------------------------------------------------------------------
# --lora-apply merge
# ---------------------------------------------------------------------------

def test_merged_lora_gives_the_unfused_loss_and_grads():
    """apply_lora(merge=True) against the unfused form (JAX
    tests/test_adapters.py:220) and both against JAX's merge_lora under
    grad."""
    params, cfg = jax_params(seed=3)
    rng = np.random.default_rng(3)
    jad = {k: {"A": ab["A"], "B": jnp.asarray(rng.normal(size=ab["B"].shape) * 0.05, jnp.float32)}
           for k, ab in jax_init_lora_params(jax.random.PRNGKey(3), params, JLC).items()}
    batch = _batch(4)
    with mock.patch.object(jwkv, "_resolve_backend", _reference_wkv):
        want_loss, want_g = jax.jit(jax.value_and_grad(lambda a: jax_sft_loss_fn(
            jax_merge_lora(params, a, JLC), cfg, _jb(batch), remat=False)))(jad)
    grads = {}
    for merge in (False, True):
        model = apply_lora(torch_model(params, cfg), LC, lora_tree_from_jax(jad), merge=merge)
        loss = sft_loss_fn(model, _tb(batch), remat=True)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        grads[merge] = {n: (m.lora_A.grad, m.lora_B.grad) for n, m in model.named_modules()
                        if isinstance(m, LoraLinear)}
    for key, (gA, gB) in grads[True].items():
        assert _rel(gA, want_g[key]["A"]) <= 1e-4 and _rel(gB, want_g[key]["B"]) <= 1e-4, key
        assert _rel(gA, grads[False][key][0]) <= 1e-4 and _rel(gB, grads[False][key][1]) <= 1e-4


def test_lora_apply_merge_command_matches_jax(tmp_path):
    check_sft_against_jax(sft_data(tmp_path), tmp_path, ["--train-type", "lora",
                                                         "--lora-apply", "merge"])


# ---------------------------------------------------------------------------
# HF-peft keys
# ---------------------------------------------------------------------------

def test_hf_peft_key_format():
    """JAX tests/test_adapters.py:97-109 on the port's reader."""
    sd = {
        "base_model.model.blocks.0.att.key.lora_A.embedding_lora.weight": np.ones((4, 64), np.float32),
        "base_model.model.blocks.0.att.key.lora_B.embedding_lora.weight": np.ones((64, 4), np.float32),
        "base_model.model.blocks.0.att.value.lora_A.other.weight": np.ones((4, 64), np.float32),
    }
    tree = lora_state_dict_to_tree(sd, adapter_name="embedding_lora")
    assert list(tree) == ["blocks.0.att.key"]
    assert tree["blocks.0.att.key"]["A"].shape == (64, 4)
    assert tree["blocks.0.att.key"]["B"].shape == (4, 64)
    jtree = jax_lora_state_dict_to_tree(sd, adapter_name="embedding_lora")
    for ab in "AB":
        np.testing.assert_array_equal(tree["blocks.0.att.key"][ab].numpy(),
                                      np.asarray(jtree["blocks.0.att.key"][ab]))


# ---------------------------------------------------------------------------
# slot-LoRA training (the port versions of tests/test_slot_lora_train.py)
# ---------------------------------------------------------------------------

SLOT_TC = dict(lr_init=1e-3, lr_final=1e-4, warmup_steps=1, total_steps=4, micro_bsz=4,
               weight_decay=0.01, grad_clip=1.0, grad_checkpoint=False)


def _slot_model(params, cfg, stacks):
    model = torch_model(params, cfg)
    apply_slot_stacks(model, {k: {n: torch.from_numpy(np.array(v, np.float32)) for n, v in ab.items()}
                              for k, ab in stacks.items()}, torch.zeros(1, dtype=torch.int64), LC)
    apply_trainable_mask(model, trainable_mask(model, "slot-lora"))
    return model


def _slot_loss(model, batch):
    set_slot_idx(model, batch["adapter_ids"])
    return sft_loss_fn(model, batch, remat=False)


def test_single_task_slot_step_matches_plain_lora():
    """One slot-LoRA step with every row on task 1 equals one plain LoRA
    step on the same batch (row 0 and the unrouted rows are zero), and the
    JAX slot step."""
    from rwkv_lm_ext_tpu.adapters import apply_slot_stacks as jax_apply_slot_stacks

    params, cfg = jax_params(seed=5)
    rng = np.random.default_rng(5)
    adapter = {k: {"A": ab["A"], "B": jnp.asarray(rng.normal(size=ab["B"].shape) * 0.05, jnp.float32)}
               for k, ab in jax_init_lora_params(jax.random.PRNGKey(1), params, JLC).items()}
    stacks = {k: {n: jnp.zeros((2,) + v.shape).at[1].set(v) for n, v in ab.items()}
              for k, ab in adapter.items()}
    batch = dict(_batch(6, B=4), adapter_ids=np.ones(4, np.int32))
    plain = apply_lora(torch_model(params, cfg), LC, lora_tree_from_jax(adapter))
    m_plain = make_train_step(plain, TrainConfig(**SLOT_TC),
                              lambda m, b: sft_loss_fn(m, b, remat=False))(_tb(batch))
    slot = _slot_model(params, cfg, stacks)
    m_slot = make_train_step(slot, TrainConfig(**SLOT_TC), _slot_loss)(_tb(batch))
    np.testing.assert_allclose(float(m_slot["loss"]), float(m_plain["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m_slot["grad_norm"]), float(m_plain["grad_norm"]), rtol=1e-5)
    got = split_slot_stacks(slot_stacks(slot), {"base": 0, "t": 1})["t"]
    for name, m in plain.named_modules():
        if isinstance(m, LoraLinear):
            np.testing.assert_allclose(got[name]["A"].numpy(), m.lora_A.detach().numpy(),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(got[name]["B"].numpy(), m.lora_B.detach().numpy(),
                                       rtol=1e-5, atol=1e-7)

    def jloss(st, frozen, cfg_, b):
        return jax_sft_loss_fn(jax_apply_slot_stacks(frozen, st, b["adapter_ids"], JLC), cfg_, b,
                               remat=False)

    init_fn, step_fn = jax_make_train_step(cfg, JaxTrainConfig(**SLOT_TC), loss_fn=jloss)
    with mock.patch.object(jwkv, "_resolve_backend", _reference_wkv):
        ts, jm = step_fn(init_fn(stacks), _jb(batch), params)
    np.testing.assert_allclose(float(m_slot["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_slot["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for key, ab in slot_stacks(slot).items():
        for n in "AB":
            assert np.abs(ab[n].numpy() - np.asarray(ts.params[key][n])).max() <= \
                1e-5 * np.abs(np.asarray(ts.params[key][n])).max(), (key, n)


def test_slot_gradients_isolate_per_task():
    """A batch routed to task 1 leaves task 2's rows and the base row 0
    exactly at their init (weight decay 0) and moves task 1's B, as in
    JAX."""
    params, cfg = jax_params(seed=6)
    model = torch_model(params, cfg)
    stacks, ids = init_slot_stacks(model, LC, ["t1", "t2"], torch.Generator().manual_seed(1))
    assert ids == {"base": 0, "t1": 1, "t2": 2}
    before = {k: {n: v.clone() for n, v in ab.items()} for k, ab in stacks.items()}
    apply_slot_stacks(model, stacks, torch.zeros(1, dtype=torch.int64), LC)
    apply_trainable_mask(model, trainable_mask(model, "slot-lora"))
    assert sorted(n for n, p in model.named_parameters() if p.requires_grad) == sorted(
        f"{k}.{n}" for k in stacks for n in "AB")
    step = make_train_step(model, TrainConfig(**dict(SLOT_TC, weight_decay=0.0)), _slot_loss)
    step(_tb(dict(_batch(7, B=4), adapter_ids=np.ones(4, np.int32))))
    for key, ab in slot_stacks(model).items():
        assert torch.equal(ab["A"][0], before[key]["A"][0]) and torch.equal(ab["B"][0], before[key]["B"][0])
        assert torch.equal(ab["A"][2], before[key]["A"][2]) and torch.equal(ab["B"][2], before[key]["B"][2])
        assert not torch.allclose(ab["B"][1], before[key]["B"][1])


def test_slot_lora_command_matches_jax(tmp_path):
    check_sft_against_jax(sft_data(tmp_path, tasks=["chat", "kg"]), tmp_path,
                          ["--train-type", "slot-lora"])


# ---------------------------------------------------------------------------
# LISA
# ---------------------------------------------------------------------------

def test_lisa_schedule_draws_the_jax_layers():
    for k, interval, seed in ((1, 2, 0), (2, 3, 5), (4, 1, 9)):
        mine, theirs = LisaSchedule(6, k, interval, seed=seed), JaxLisaSchedule(6, k, interval, seed=seed)
        assert [mine.active_layers(s) for s in range(12)] == [theirs.active_layers(s) for s in range(12)]


def test_lisa_steps_match_jax():
    """Three full-parameter steps on 3 layers with LISA (interval 2, k=1)
    against JAX's update mask: loss and grad_norm, every parameter after
    the steps (within 1e-5 of its largest value or half the lr, TRAINER_DOC's
    rule for Adam steps); the blocks that never trained keep their values
    while their Adam moments advance."""
    params, cfg = jax_params(seed=8, n_layer=3)
    model = torch_model(params, cfg)
    apply_trainable_mask(model, trainable_mask(model, "full"))
    kw = dict(lr_init=LR, lr_final=LR / 10, warmup_steps=0, total_steps=3, weight_decay=0.01,
              grad_clip=1.0, grad_checkpoint=False)
    step = make_train_step(model, TrainConfig(**kw))
    init_fn, jstep = jax_make_train_step(cfg, JaxTrainConfig(**kw))
    ts = init_fn(params)
    lisa, jlisa = LisaSchedule(3, k=1, interval=2, seed=3), JaxLisaSchedule(3, k=1, interval=2, seed=3)
    names = [n for n, _ in model.named_parameters()]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trained = set()
    for s in range(3):
        b = _batch(10 + s)
        trained |= set(lisa.active_layers(s))
        jmask = jax.tree_util.tree_map(lambda m: jnp.asarray(1.0 if m else 0.0),
                                       jlisa.trainable_mask(ts.params, s))
        with mock.patch.object(jwkv, "_resolve_backend", _reference_wkv):
            ts, jm = jstep(ts, _jb(b), None, jmask)
        m = step(_tb(b), lisa.trainable_mask(names, s))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert trained != {0, 1, 2}, trained           # a block stayed out
    want = jax_params_to_state_dict(ts.params, cfg)
    adam = step.optimizer.opt
    for name, p in model.named_parameters():
        assert np.abs(p.detach().numpy() - want[name]).max() <= max(
            1e-5 * np.abs(want[name]).max(), 0.5 * LR), name
        if name.startswith("blocks.") and int(name.split(".")[1]) not in trained:
            assert torch.equal(p.detach(), before[name]), name
            assert int(adam.state[p]["step"]) == 3 and bool(adam.state[p]["exp_avg_sq"].abs().max() > 0)


def test_lisa_command_matches_jax(tmp_path):
    check_sft_against_jax(sft_data(tmp_path), tmp_path,
                          ["--train-type", "full", "--lisa-k", "1", "--lisa-interval", "2"])


def test_full_command_matches_jax(tmp_path):
    check_sft_against_jax(sft_data(tmp_path), tmp_path, ["--train-type", "full"])
