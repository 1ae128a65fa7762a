"""GPipe pipeline training of the port (parallel/pipeline.py, train/loop.py
``make_pp_train_step``) against the JAX package's ``pipeline_loss`` and
``make_pp_train_step`` on ``make_pp_mesh(dp=1, pp=2)``, on the CPU.

Two ranks over gloo (tests/torch_train_ranks.py job ``pp``, started before
the JAX references are computed) hold one stage each of a tiny fp32 RWKV-6
(2 layers, C=128: torch_stack_setup.seeded_weights, the low-rank mixers
filled) and run ``n_micro=2`` micro-batches of a 4-row batch whose
micro-batches hold different counts of unmasked tokens: the loss (rtol 1e-5)
and every stage's gradients (within 1e-4 of the largest |JAX value|) against
JAX's ``pipeline_loss`` and its gradient, then one ``make_pp_train_step``
step: its loss, grad_norm (rtol 1e-4) and the stage parameters after it
(within 1e-5 of the largest |JAX value| plus 2e-2 of the step's move,
tests/test_torch_dp.py's ``STEP_FLOOR``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.config import TrainConfig as JaxTrainConfig
from rwkv_lm_ext_tpu.models.stacked import stack_params_uniform, unstack_params_uniform
from rwkv_lm_ext_tpu.parallel.pipeline import make_pp_mesh as jax_make_pp_mesh
from rwkv_lm_ext_tpu.parallel.pipeline import pipeline_loss as jax_pipeline_loss
from rwkv_lm_ext_tpu.train.loop import make_pp_train_step as jax_make_pp_train_step
from rwkv_lm_ext_tpu.train.loop import place_pp_train_state
from rwkv_lm_ext_tpu_torch.parallel.pipeline import stage_layers
from torch_stack_setup import seeded_weights
from torch_tp_ranks import TP, Pair

torch.set_num_threads(1)  # tier-1 runs several pytest workers

# no weight decay: JAX's pipeline trains the stacked tree, where stacking
# makes every LayerNorm and mixing vector 2-D, so optax's ndim >= 2 mask decays
# them all; the port keeps the flat layout's mask (ROADMAP C.30)
TC = dict(lr_init=1e-3, lr_final=1e-4, warmup_steps=0, total_steps=4, weight_decay=0.0,
          grad_checkpoint=False)
N_MICRO = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    d = tmp_path_factory.mktemp("pp_ranks")
    sd, params, jcfg = seeded_weights(5)
    rng = np.random.default_rng(6)
    B, T = 4, 16
    ids = rng.integers(3, jcfg.vocab_size, size=(B, T)).astype(np.int32)
    labels = np.full_like(ids, -100)
    labels[:, :-1] = ids[:, 1:]
    labels[: B // N_MICRO, : T // 2] = -100      # micro-batch 0 holds fewer tokens
    torch.save({"sd": sd, "tc": TC, "n_micro": N_MICRO,
                "batch": {"input_ids": torch.from_numpy(ids).long(),
                          "labels": torch.from_numpy(labels).long()}}, d / "pp.pt")
    pair = Pair("pp", d, script=str(request.config.rootpath / "tests" / "torch_train_ranks.py"))

    mesh = jax_make_pp_mesh(dp=1, pp=TP, devices=jax.devices()[:TP])
    sparams = stack_params_uniform(params)
    toks, labs = jnp.asarray(ids), jnp.asarray(labels)

    def loss(sp):
        return jax_pipeline_loss(sp, jcfg, toks, labs, mesh, n_micro=N_MICRO,
                                 wkv_backend="reference")

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(sparams)
    init_fn, step_fn = jax_make_pp_train_step(jcfg, JaxTrainConfig(**TC), mesh, n_micro=N_MICRO,
                                              wkv_backend="reference", donate=False)
    ts = place_pp_train_state(init_fn(sparams), mesh)
    ts, m = step_fn(ts, {"input_ids": toks, "labels": labs})
    want = {"loss": float(want_loss), "step_loss": float(m["loss"]),
            "step_norm": float(m["grad_norm"]),
            "grads": jax_params_to_state_dict(unstack_params_uniform(want_grads), jcfg),
            "params": jax_params_to_state_dict(unstack_params_uniform(ts.params), jcfg)}
    return pair.results(), want, jcfg


def _close(got, want, rel, name, floor=0.0):
    got = got.double().numpy()
    want = np.asarray(want, np.float64).reshape(got.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + floor, (name, err, np.abs(want).max())


def test_pipeline_loss_and_gradients_match_jax(runs):
    got, want, jcfg = runs
    assert [g["stage"] for g in got] == list(range(TP))
    # the last stage holds the loss; the others contribute 0
    np.testing.assert_allclose(got[-1]["loss"], want["loss"], rtol=1e-5)
    assert all(g["loss"] == 0.0 for g in got[:-1])
    seen = {}
    for g in got:
        for name, grad in g["grads"].items():
            assert name not in seen, f"{name} is held by two stages"
            seen[name] = g["stage"]
            _close(grad, want["grads"][name], 1e-4, f"grad {name}")
    assert sorted(seen) == sorted(want["grads"])
    # each stage holds its own layers, stage 0 the embedding, the last the head
    for name, stage in seen.items():
        if name.startswith("blocks."):
            assert int(name.split(".")[1]) in stage_layers(jcfg.n_layer, TP, stage), name
    assert seen["emb.weight"] == 0 and seen["head.weight"] == TP - 1


def test_pipeline_train_step_matches_jax(runs):
    got, want, _ = runs
    for g in got:
        np.testing.assert_allclose(g["step_loss"], want["step_loss"], rtol=1e-5)
        np.testing.assert_allclose(g["step_norm"], want["step_norm"], rtol=1e-4)
        for name, value in g["params"].items():
            _close(value, want["params"][name], 1e-5, f"param {name}", 2e-2 * TC["lr_init"])
