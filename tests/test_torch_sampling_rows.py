"""The port's per-row sampling (the continuous batcher's) against the JAX
package's on the same logits.

Tolerances: the filters keep the same tokens and their values agree to
rtol 1e-6 (the same fp32 operations); picks given JAX's own noise are
equal; greedy rows are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.infer.sampling import SamplingParams as JaxSamplingParams
from rwkv_lm_ext_tpu.infer.sampling import apply_top_p_bisect_rows as jax_top_p_bisect_rows
from rwkv_lm_ext_tpu.infer.sampling import apply_top_p_rows as jax_top_p_rows
from rwkv_lm_ext_tpu.infer.sampling import sample_token_rows as jax_sample_token_rows
from rwkv_lm_ext_tpu.infer.sampling import slot_params as jax_slot_params
from rwkv_lm_ext_tpu_torch.infer.sampling import (
    SLOT_PARAM_FIELDS,
    SamplingParams,
    apply_top_p_bisect_rows,
    apply_top_p_rows,
    penalize_and_filter_rows,
    pick_token_rows,
    sample_token_rows,
    slot_params,
)

torch.set_num_threads(1)  # tier-1 runs several pytest workers

B, V = 6, 400


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    occ = (rng.integers(0, 3, size=(B, V)) * (rng.uniform(size=(B, V)) < 0.1)).astype(np.float32)
    rows = {
        "temperature": np.array([0.0, 1.0, 0.7, 1.3, 0.0, 0.5], np.float32),
        "top_p": np.array([0.85, 1.0, 0.5, 0.95, 0.3, 1.2], np.float32),
        "alpha_presence": np.array([0.25, 0.0, 0.5, 0.1, 0.3, 0.0], np.float32),
        "alpha_frequency": np.array([0.25, 0.0, 0.1, 0.7, 0.0, 0.2], np.float32),
        "alpha_decay": np.array([0.996, 1.0, 0.9, 0.99, 0.5, 0.8], np.float32),
        "repetition_penalty": np.array([1.0, 1.3, 1.0, 2.0, 1.1, 0.9], np.float32),
    }
    return logits, occ, rows


def _t(rows):
    return {k: torch.from_numpy(v) for k, v in rows.items()}


def _j(rows):
    return {k: jnp.asarray(v) for k, v in rows.items()}


def test_slot_params_match_jax():
    sp = SamplingParams(temperature=0.3, top_p=0.7, alpha_decay=0.9)
    jsp = JaxSamplingParams(temperature=0.3, top_p=0.7, alpha_decay=0.9)
    got, want = slot_params(3, sp, device="cpu"), jax_slot_params(3, jsp)
    assert tuple(got) == SLOT_PARAM_FIELDS == tuple(want)
    for f in SLOT_PARAM_FIELDS:
        assert got[f].dtype == torch.float32
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))


@pytest.mark.parametrize("fn,jfn", [(apply_top_p_rows, jax_top_p_rows),
                                    (apply_top_p_bisect_rows, jax_top_p_bisect_rows)])
def test_top_p_rows_match_jax(fn, jfn):
    logits, _, rows = _inputs(1)
    p = rows["top_p"]
    want = np.asarray(jfn(jnp.asarray(logits), jnp.asarray(p)))
    got = fn(torch.from_numpy(logits), torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    kept = np.isfinite(want)
    np.testing.assert_allclose(got[kept], want[kept], rtol=1e-6, atol=0)
    # the sorted filter keeps every token at p >= 1; smaller p filter some
    assert not kept[4].all()
    if fn is apply_top_p_rows:
        assert kept[1].all() and kept[5].all()


@pytest.mark.parametrize("knobs", [
    {},
    {"top_k": 30},
    {"top_p_impl": "bisect"},
    {"token_ban": (3, 7, 11)},
    {"categorical_impl": "invcdf"},
])
def test_sample_token_rows_with_jax_noise(knobs):
    """The port's filtered logits match JAX's; given JAX's noise, every
    row's pick and the new occurrences are equal (greedy rows too)."""
    logits, occ, rows = _inputs(2 + len(knobs))
    sp, jsp = SamplingParams(**knobs), JaxSamplingParams(**knobs)
    key = jax.random.PRNGKey(7)
    want_tok, want_occ = jax_sample_token_rows(key, jnp.asarray(logits), jnp.asarray(occ),
                                               _j(rows), jsp)
    filtered = penalize_and_filter_rows(torch.from_numpy(logits), torch.from_numpy(occ),
                                        _t(rows), sp)
    tempered = filtered.numpy() / np.maximum(rows["temperature"][:, None], 1e-6)
    if sp.categorical_impl == "invcdf":
        noise = np.array(jax.random.uniform(key, (B, 1), jnp.float32))
    else:
        noise = np.array(jax.random.gumbel(key, (B, V), jnp.float32))
        # jax.random.categorical is argmax(logits + gumbel): same pick
        np.testing.assert_array_equal(
            np.argmax(tempered + noise, -1)[rows["temperature"] > 0],
            np.asarray(want_tok)[rows["temperature"] > 0])
    tok = pick_token_rows(filtered, torch.from_numpy(noise), _t(rows), sp)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    greedy = rows["temperature"] == 0
    np.testing.assert_array_equal(tok.numpy()[greedy], filtered.numpy().argmax(-1)[greedy])
    occ_new = torch.from_numpy(occ) * _t(rows)["alpha_decay"][:, None]
    occ_new[torch.arange(B), tok] += 1
    np.testing.assert_allclose(occ_new.numpy(), np.asarray(want_occ), rtol=1e-6, atol=0)


def test_sample_token_rows_runs_with_a_generator():
    logits, occ, rows = _inputs(9)
    gen = torch.Generator().manual_seed(0)
    tok, occ_new = sample_token_rows(torch.from_numpy(logits), torch.from_numpy(occ), _t(rows),
                                     SamplingParams(), gen)
    assert tok.shape == (B,) and tok.dtype == torch.int64
    filtered = penalize_and_filter_rows(torch.from_numpy(logits), torch.from_numpy(occ),
                                        _t(rows), SamplingParams())
    greedy = rows["temperature"] == 0
    np.testing.assert_array_equal(tok.numpy()[greedy], filtered.numpy().argmax(-1)[greedy])
    assert np.isfinite(filtered.numpy()[np.arange(B), tok.numpy()]).all()
    assert (occ_new.sum(-1) - (torch.from_numpy(occ) * _t(rows)["alpha_decay"][:, None]).sum(-1)
            ).allclose(torch.ones(B))
    # the same seed draws the same tokens
    again = sample_token_rows(torch.from_numpy(logits), torch.from_numpy(occ), _t(rows),
                              dataclasses.replace(SamplingParams()),
                              torch.Generator().manual_seed(0))[0]
    assert torch.equal(tok, again)
