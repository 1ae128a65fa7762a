"""The port's beam search against the JAX package's on the same weights
(fp32): in deterministic (greedy) beam mode the ranked sequences are equal
and their scores agree within 1e-4; one beam without penalties is greedy
decoding; the sampled mode runs and its seed fixes it."""
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.infer.beam import BeamParams as JaxBeamParams
from rwkv_lm_ext_tpu.infer.beam import generate_beamsearch as jax_generate_beamsearch
from rwkv_lm_ext_tpu.infer.engine import GenerationEngine as JaxGenerationEngine
from rwkv_lm_ext_tpu_torch.infer.beam import BeamParams, generate_beamsearch
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from torch_stack_setup import GREEDY, jax_params, torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers


@pytest.fixture(scope="module")
def engines():
    params, cfg = jax_params(seed=9, vocab_size=300)
    return (JaxGenerationEngine(params, cfg, chunk_len=8, wkv_backend="reference"),
            GenerationEngine(torch_model(params, cfg), chunk_len=8))


@pytest.mark.parametrize("knobs", [
    dict(num_beams=6, num_groups=2, return_num_sequences=4, max_tokens=10, eos_ids=(0,)),
    dict(num_beams=4, num_groups=4, return_num_sequences=4, max_tokens=8, eos_ids=(3, 7),
         repetition_penalty=1.0, length_penalty=1.0),
])
def test_greedy_beams_match_jax(engines, knobs):
    jeng, eng = engines
    want = jax_generate_beamsearch(jeng, [5, 6, 7], JaxBeamParams(do_sample=False, **knobs))
    got = generate_beamsearch(eng, [5, 6, 7], BeamParams(do_sample=False, **knobs))
    assert len(got) == len(want) >= 1
    assert [ids for _, ids in got] == [[int(t) for t in ids] for _, ids in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want], rtol=1e-4, atol=1e-4)
    scores = [s for s, _ in got]
    assert scores == sorted(scores, reverse=True)


def test_one_beam_is_greedy_decoding(engines):
    _, eng = engines
    bp = BeamParams(num_beams=1, num_groups=1, return_num_sequences=1, max_tokens=5,
                    do_sample=False, eos_ids=(), repetition_penalty=1.0, length_penalty=0.0)
    out = generate_beamsearch(eng, [5, 6, 7], bp)
    assert out[0][1] == eng.generate([5, 6, 7], max_tokens=5, sampling=SamplingParams(**GREEDY))


def test_sampled_mode_runs(engines):
    _, eng = engines
    bp = BeamParams(num_beams=4, num_groups=2, return_num_sequences=2, max_tokens=8,
                    do_sample=True, eos_ids=(0, 1))
    out = generate_beamsearch(eng, [9, 10], bp, seed=3)
    assert 1 <= len(out) <= 2
    assert all(0 <= t < 300 for _, ids in out for t in ids)
    assert generate_beamsearch(eng, [9, 10], bp, seed=3) == out
