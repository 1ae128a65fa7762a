"""The port's prompt prefix cache against the JAX package's, and its use by
the engine: lookups and inserts answer as the JAX cache does on the same
sequences; greedy generation gives the same tokens with and without the
cache (fp32, token-equal); cached entries are private clones, so they
survive in-place decoding; an explicit initial state bypasses the cache; an
identical repeated prompt resumes from its last chunk boundary with the same
logits (rtol 1e-6); salts keep adapters apart."""
import jax.numpy as jnp
import pytest
import torch

from rwkv_lm_ext_tpu.infer.state_cache import PrefixStateCache as JaxPrefixStateCache
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.infer.state_cache import PrefixStateCache
from torch_stack_setup import GREEDY, jax_params, torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers

SP = SamplingParams(**GREEDY)


@pytest.fixture(scope="module")
def model():
    return torch_model(*jax_params(seed=3))


def _script():
    """(op, tokens, salt) steps exercising min_prefix, strict prefixes,
    longest match, salts, repeats and LRU eviction."""
    return [
        ("insert", [1, 2], None), ("insert", [1, 2, 3], None), ("insert", [1, 2, 3, 4, 5], None),
        ("lookup", [1, 2, 3], None), ("lookup", [1, 2, 3, 4], None),
        ("lookup", [1, 2, 3, 4, 5, 6], None), ("lookup", [1, 2, 3, 4, 5, 6], "a"),
        ("insert", [1, 2, 3, 4], "a"), ("lookup", [1, 2, 3, 4, 5, 6], "a"),
        ("insert", [1, 2, 3], None), ("lookup", [1, 2, 3, 99], None),
        ("insert", [7, 8, 9, 10], None), ("lookup", [1, 2, 3, 4, 5, 6], None),
        ("lookup", [7, 8, 9, 10, 11], None), ("lookup", [1, 2, 3, 4, 9], "a"),
    ]


def test_lookup_and_insert_answer_as_the_jax_cache():
    ours, theirs = PrefixStateCache(capacity=3, min_prefix=3), JaxPrefixStateCache(3, 3)
    for n, (op, tokens, salt) in enumerate(_script()):
        if op == "insert":
            ours.insert(tokens, {"x": torch.full((2,), float(n))}, salt=salt)
            theirs.insert(tokens, {"x": jnp.full((2,), float(n))}, salt=salt)
        else:
            got, got_n = ours.lookup(tokens, salt=salt)
            want, want_n = theirs.lookup(tokens, salt=salt)
            assert got_n == want_n, (n, tokens, salt)
            assert (got is None) == (want is None)
            if got is not None:
                assert got["x"].tolist() == [float(v) for v in want["x"]]
        assert ours.stats() == theirs.stats(), n


def test_lookups_hand_out_clones():
    cache = PrefixStateCache(capacity=2, min_prefix=1)
    state = {"x": torch.zeros(3)}
    cache.insert([1, 2], state)
    state["x"].add_(5)                       # the caller's buffer moves on
    hit, n = cache.lookup([1, 2, 3])
    assert n == 2 and hit["x"].tolist() == [0.0, 0.0, 0.0]
    hit["x"].add_(7)                         # and so does the borrower's
    assert cache.lookup([1, 2, 3])[0]["x"].tolist() == [0.0, 0.0, 0.0]


def test_cached_generation_matches_uncached_and_survives_in_place_decoding(model):
    cache = PrefixStateCache(capacity=4, min_prefix=4)
    eng = GenerationEngine(model, state_cache=cache)
    plain = GenerationEngine(model)
    prompt = [7, 21, 9, 13, 2]
    first = eng.generate(prompt + [1, 2], max_tokens=8, sampling=SP)
    # those 8 steps decoded in place; the cached prefix still serves
    again = eng.generate(prompt + [1, 2, 3], max_tokens=8, sampling=SP)
    assert first == plain.generate(prompt + [1, 2], max_tokens=8, sampling=SP)
    assert again == plain.generate(prompt + [1, 2, 3], max_tokens=8, sampling=SP)
    assert cache.hits >= 1


def test_explicit_initial_state_bypasses_the_cache(model):
    cache = PrefixStateCache(capacity=4, min_prefix=2)
    eng = GenerationEngine(model, state_cache=cache)
    eng.prefill([5, 9, 23, 7, 2], state=eng.init_state(1))
    assert cache.stats() == {"entries": 0, "capacity": 4, "hits": 0, "misses": 0}


def test_identical_prompt_hits_its_boundary_state(model):
    cache = PrefixStateCache(capacity=8, min_prefix=4)
    eng = GenerationEngine(model, state_cache=cache, chunk_len=8)
    prompt = [5 + (i % 60) for i in range(20)]          # 8 + 8 + 4
    l1, s1 = eng.prefill(prompt)
    h0 = cache.hits
    l2, s2 = eng.prefill(prompt)
    assert cache.hits == h0 + 1
    torch.testing.assert_close(l2, l1, rtol=1e-6, atol=1e-6)
    for key in s1:
        torch.testing.assert_close(s2[key], s1[key], rtol=1e-6, atol=1e-6)


def test_salts_keep_adapters_apart(model):
    cache = PrefixStateCache(capacity=8, min_prefix=2)
    eng = GenerationEngine(model, state_cache=cache)
    eng.prefill([4, 5, 6, 7])                           # the base's entries
    assert cache.lookup([4, 5, 6, 7, 8], salt="a") == (None, 0)
    assert cache.lookup([4, 5, 6, 7, 8])[1] == 4
