"""Sequence parallelism (parallel/sequence.py), the chunked WKV of the JAX
package's XLA backend (ops/wkv_chunked.py) and the log-space associative scan
of RWKV-4 (ops/wkv4.py ``wkv4_parallel``) against the JAX package, on the CPU.

- ``wkv_chunked``'s plain version (``wkv_tiled_plain``) against JAX's
  ``wkv_chunked`` at chunks of 8, 16, 24 and 32 over a T that is no multiple
  of them, decays in [-6, 0.5] and up to +3, with a bonus and an initial
  state: y, the final state and the autograd gradients of all six inputs
  within 2e-4 of max (JAX's own sequential-reference tolerance,
  tests/test_parallel.py:187-188).
- ``wkv4_parallel`` against JAX's and against the port's sequential
  ``wkv4_plain``, whole and as 17 steps + the rest with the state carried
  (tests/test_preprocess_wkv4.py:92-125: rtol 1e-4, atol 1e-5).
- Four ranks over gloo (tests/torch_train_ranks.py job ``sp``, a file
  rendezvous under the module's temporary directory, started before the JAX
  references are computed) at sp = 4 and at sp = 2 (two groups of two),
  against JAX's functions on ``jax.devices()[:sp]`` of the 8-device CPU mesh
  (tests/conftest.py): ``wkv6_sequence_parallel`` 2e-4, the model forward's
  logits 3e-4 and the gradients of mean(logits^2) summed over the group
  within a worst relative 5e-3 (JAX's own tolerances,
  tests/test_parallel.py:187-188, 212, 250). Shards of two lengths are
  refused by name, as are the models JAX's forward cannot run or ignores.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.ops.wkv4 import wkv4_parallel as jax_wkv4_parallel
from rwkv_lm_ext_tpu.ops.wkv_chunked import wkv_chunked as jax_wkv_chunked
from rwkv_lm_ext_tpu.parallel.sequence import (
    rwkv_forward_sequence_parallel as jax_forward_sp,
    wkv6_sequence_parallel as jax_wkv6_sp,
)
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.ops.wkv4 import wkv4_parallel, wkv4_plain
from rwkv_lm_ext_tpu_torch.ops.wkv_chunked import wkv_chunked, wkv_tiled_plain
from rwkv_lm_ext_tpu_torch.parallel.sequence import (
    SpMesh,
    rwkv_forward_sequence_parallel,
    sp_refusal,
)
from torch_stack_setup import seeded_weights
from torch_tp_ranks import Pair

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = Path(__file__).resolve().parent.parent
SP_RANKS = 4


def _wkv_inputs(rng, B, T, H, N, wmax):
    r, k, v = (rng.normal(size=(B, T, H, N)).astype(np.float32) for _ in range(3))
    w = rng.uniform(-6.0, wmax, size=(B, T, H, N)).astype(np.float32)
    u = (rng.normal(size=(H, N)) * 0.5).astype(np.float32)
    s0 = (rng.normal(size=(B, H, N, N)) * 0.3).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("wmax", [0.5, 3.0], ids=["w_to_0.5", "w_to_3"])
@pytest.mark.parametrize("chunk", [8, 16, 24, 32])
def test_wkv_chunked_plain_matches_jax_with_gradients(chunk, wmax):
    rng = np.random.default_rng(chunk + int(wmax))
    B, T, H, N = 1, 45, 2, 8
    inputs = _wkv_inputs(rng, B, T, H, N, wmax)
    gy = rng.normal(size=(B, T, H, N)).astype(np.float32)
    gs = rng.normal(size=(B, H, N, N)).astype(np.float32)

    def jax_loss(*args):
        y, s = jax_wkv_chunked(*args, chunk_size=chunk)
        return jnp.sum(y * gy) + jnp.sum(s * gs), (y, s)

    (_, (want_y, want_s)), want_g = jax.jit(jax.value_and_grad(
        jax_loss, argnums=tuple(range(6)), has_aux=True))(*map(jnp.asarray, inputs))
    leaves = [torch.from_numpy(x).requires_grad_() for x in inputs]
    y, s = wkv_tiled_plain(*leaves, chunk_size=chunk)
    ((y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum()).backward()
    for name, got, want in [("y", y, want_y), ("state", s, want_s)] + [
            (f"d{n}", t.grad, g) for n, t, g in zip(("r", "k", "v", "w", "u", "s0"), leaves,
                                                    want_g)]:
        want = np.asarray(want)
        err = np.abs(got.detach().numpy() - want).max()
        assert err <= 2e-4 * max(np.abs(want).max(), 1.0), (name, err)


def test_wkv_chunked_takes_the_plain_version_on_the_cpu():
    inputs = [torch.from_numpy(x) for x in _wkv_inputs(np.random.default_rng(1), 2, 20, 2, 8, 0.5)]
    got, want = wkv_chunked(*inputs, chunk_size=8), wkv_tiled_plain(*inputs, chunk_size=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _wkv4_inputs():
    rng = np.random.default_rng(7)
    B, T, C = 2, 33, 8
    k = (rng.normal(size=(B, T, C)) * 2.0).astype(np.float32)
    v = rng.normal(size=(B, T, C)).astype(np.float32)
    w = (-np.exp(rng.normal(size=(C,)))).astype(np.float32)
    u = rng.normal(size=(C,)).astype(np.float32)
    return k, v, w, u


def _one_more_step(state, k, v, w, u):
    """The next output a state gives: (aa, bb, pp) is unique only up to
    the max-exponent shift, so states are compared by their effect."""
    return wkv4_plain(k[:, :1], v[:, :1], w, u, state)[0]


def test_wkv4_parallel_matches_jax_and_the_sequential_scan():
    arrays = _wkv4_inputs()
    k, v, w, u = map(torch.from_numpy, arrays)
    y, state = wkv4_parallel(k, v, w, u)
    jy, jstate = jax.jit(jax_wkv4_parallel)(*map(jnp.asarray, arrays))
    ys, sstate = wkv4_plain(k, v, w, u)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), ys.numpy(), rtol=1e-4, atol=1e-5)
    for got, want in zip(state, jstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_one_more_step(state, k, v, w, u).numpy(),
                               _one_more_step(sstate, k, v, w, u).numpy(), rtol=1e-4, atol=1e-5)


def test_wkv4_parallel_carries_its_state_across_a_split():
    """17 steps, then the rest from the carried state, equal the whole
    sequential scan (and JAX's parallel form on the same split)."""
    arrays = _wkv4_inputs()
    k, v, w, u = map(torch.from_numpy, arrays)
    y1, s1 = wkv4_parallel(k[:, :17], v[:, :17], w, u)
    y2, s2 = wkv4_parallel(k[:, 17:], v[:, 17:], w, u, s1)
    ys, sstate = wkv4_plain(k, v, w, u)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), ys.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_one_more_step(s2, k, v, w, u).numpy(),
                               _one_more_step(sstate, k, v, w, u).numpy(), rtol=1e-4, atol=1e-5)
    jk, jv, jw, ju = map(jnp.asarray, arrays)
    scan = jax.jit(jax_wkv4_parallel)
    _, js1 = scan(jk[:, :17], jv[:, :17], jw, ju)
    jy2, _ = scan(jk[:, 17:], jv[:, 17:], jw, ju, js1)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# sequence parallelism over gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """The four ranks' results and JAX's on the same inputs: {sp: {"wkv":
    (y, state), "logits", "grads" (port names)}}."""
    d = tmp_path_factory.mktemp("sp_ranks")
    sd, params, jcfg = seeded_weights(5, n_layer=2, n_embd=64, vocab_size=128, head_size=16)
    rng = np.random.default_rng(5)
    r, k, v, w, u, _ = _wkv_inputs(rng, 2, 64, 2, 8, 0.5)
    tokens = rng.integers(0, 128, size=(2, 64))
    grad_tokens = rng.integers(0, 128, size=(2, 32))
    torch.save({"sd": sd, "wkv": {n: torch.from_numpy(x) for n, x in zip("rkvwu", (r, k, v, w, u))},
                "tokens": torch.from_numpy(tokens), "grad_tokens": torch.from_numpy(grad_tokens)},
               d / "sp.pt")
    ranks = Pair("sp", d, script=str(REPO / "tests" / "torch_train_ranks.py"), ranks=SP_RANKS)
    want = {}
    for sp in (SP_RANKS, 2):
        mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
        # jitted: shard_map run op by op takes minutes on the CPU
        y, s = jax.jit(lambda *a: jax_wkv6_sp(*a, mesh=mesh, chunk_size=8))(
            *map(jnp.asarray, (r, k, v, w, u)))
        forward = jax.jit(lambda p, t: jax_forward_sp(p, jcfg, t, mesh=mesh))
        logits = forward(params, jnp.asarray(tokens))

        def loss(p):
            return jnp.mean(forward(p, jnp.asarray(grad_tokens)).astype(jnp.float32) ** 2)

        grads = jax_params_to_state_dict(jax.jit(jax.grad(loss))(params), jcfg)
        want[sp] = {"wkv": (np.asarray(y), np.asarray(s)), "logits": np.asarray(logits),
                    "grads": {n: np.asarray(g) for n, g in grads.items()}}
    return ranks.results(), want


@pytest.mark.parametrize("sp", [SP_RANKS, 2])
def test_wkv6_sequence_parallel_matches_jax(sp_runs, sp):
    got, want = sp_runs
    y_want, s_want = want[sp]["wkv"]
    for res in got:
        out = res[sp]
        n = y_want.shape[1] // sp
        shard = y_want[:, out["rank"] * n:(out["rank"] + 1) * n]
        np.testing.assert_allclose(out["y"].numpy(), shard, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out["state"].numpy(), s_want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sp", [SP_RANKS, 2])
def test_forward_sequence_parallel_logits_match_jax(sp_runs, sp):
    got, want = sp_runs
    logits = want[sp]["logits"]
    for res in got:
        out = res[sp]
        n = logits.shape[1] // sp
        np.testing.assert_allclose(out["logits"].numpy(),
                                   logits[:, out["rank"] * n:(out["rank"] + 1) * n],
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("sp", [SP_RANKS, 2])
def test_forward_sequence_parallel_gradients_match_jax(sp_runs, sp):
    """The gradients summed over the group: every tensor within a worst
    relative 5e-3 of JAX's (scale max(max|JAX|, 1e-3), as JAX's test), the
    same on every rank of the group."""
    got, want = sp_runs
    worst = 0.0
    for res in got:
        grads = res[sp]["grads"]
        assert sorted(grads) == sorted(want[sp]["grads"])
        for name, g in grads.items():
            ref = want[sp]["grads"][name].reshape(g.shape)
            worst = max(worst, float(np.abs(g.numpy() - ref).max()) / max(np.abs(ref).max(), 1e-3))
    assert worst < 5e-3, worst


def test_shards_of_two_lengths_are_refused_by_name(sp_runs):
    got, _ = sp_runs
    for res in got:
        assert "every rank of the sp group must hold a shard of the same shape" in res["mismatch"]


@pytest.mark.parametrize("overrides, match", [
    (dict(version=5.2), "RWKV-6 time mix only"),
    (dict(version=4.0, head_size=64), "RWKV-6 time mix only"),
    (dict(head_qk=8), "head_qk"),
    (dict(tiny_att_dim=8, tiny_att_layer=1), "tiny_att_dim"),
    (dict(my_pos_emb=4), "my_pos_emb"),
    (dict(pre_ffn=1), "pre_ffn"),
    (dict(ffn_type="mishglu"), "mishglu"),
])
def test_models_the_forward_cannot_run_are_refused_by_name(overrides, match):
    cfg = ModelConfig(**dict(dict(n_layer=2, n_embd=64, vocab_size=128, head_size=16), **overrides))
    assert match in sp_refusal(cfg)
    with pytest.raises(ValueError, match=match):
        rwkv_forward_sequence_parallel(RWKV(cfg, device="meta"), torch.zeros(1, 8, dtype=torch.long),
                                       mesh=SpMesh(sp=1, rank=0))
