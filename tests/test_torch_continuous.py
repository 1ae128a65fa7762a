"""The port's continuous batcher against per-request generation and against
the JAX package's ContinuousBatcher on the same weights (fp32, 2 layers,
C=128). Greedy outputs are token-equal in both modes (per-token ticks and
K-step blocks), with per-request stop tokens, budgets and penalties; the
block-mode bookkeeping (cancellation, grouped admission, the adaptive
block, a mixed-adapter pool, the driver) keeps them equal. Two faults of
the JAX batcher are left behind, each pinned by a test that the
JAX logic fails."""
import copy
import threading

import jax
import jax.numpy as jnp
import pytest
import torch

from rwkv_lm_ext_tpu.adapters import LoraConfig as JaxLoraConfig
from rwkv_lm_ext_tpu.adapters import init_lora_params as jax_init_lora_params
from rwkv_lm_ext_tpu.infer.continuous import ContinuousBatcher as JaxContinuousBatcher
from rwkv_lm_ext_tpu.infer.engine import GenerationEngine as JaxGenerationEngine
from rwkv_lm_ext_tpu.infer.sampling import SamplingParams as JaxSamplingParams
from rwkv_lm_ext_tpu_torch.adapters.lora import LoraConfig, apply_lora, merge_lora
from rwkv_lm_ext_tpu_torch.adapters.slot_lora import build_slot_lora
from rwkv_lm_ext_tpu_torch.checkpoint.convert import lora_tree_from_jax
from rwkv_lm_ext_tpu_torch.infer.continuous import BatcherDriver, ContinuousBatcher, _Request
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.infer.state_cache import PrefixStateCache
from torch_stack_setup import GREEDY, jax_params, torch_model

torch.set_num_threads(1)  # tier-1 runs several pytest workers

SP = SamplingParams(**GREEDY)
PROMPTS = [[5, 9, 23], [77, 3], [14, 14, 14, 60], [99], [31, 8, 120, 44, 2], [6, 7, 8]]
MAXES = [6, 4, 9, 3, 5, 1]
# per-request greedy knobs: penalties move the argmax, the stop set cuts
KNOBS = [{}, {"alpha_presence": 0.5, "alpha_frequency": 0.3}, {"repetition_penalty": 0.125},
         {}, {"alpha_decay": 0.5, "alpha_frequency": 1.0}, {}]


@pytest.fixture(scope="module")
def weights():
    return jax_params(seed=6)


@pytest.fixture(scope="module")
def engine(weights):
    return GenerationEngine(torch_model(*weights))


def _sp(knobs, cls=SamplingParams):
    return cls(**{**GREEDY, **knobs})


def _expected(engine, stops=None):
    return [engine.generate(p, max_tokens=m, sampling=_sp(dict(k, **(stops or {}).get(i, {}))))
            for i, (p, m, k) in enumerate(zip(PROMPTS, MAXES, KNOBS))]


@pytest.mark.parametrize("block", [1, 4, 16])
def test_greedy_outputs_equal_generate_and_the_jax_batcher(engine, weights, block):
    """Six requests through two slots (re-admission mid-block), per-request
    penalties and budgets, one request stopped by its own stop token."""
    full = engine.generate(PROMPTS[4], max_tokens=5, sampling=_sp(KNOBS[4]))
    cut = next(i for i in range(2, 5) if full[i] not in full[:i])
    stops = {4: {"token_stop": (full[cut],)}}
    want = _expected(engine, stops)
    assert want[4] == full[:cut]
    batcher = ContinuousBatcher(engine, n_slots=2, sampling=SP, block_size=block)
    rids = [batcher.submit(p, max_tokens=m, sampling=_sp(dict(k, **stops.get(i, {}))))
            for i, (p, m, k) in enumerate(zip(PROMPTS, MAXES, KNOBS))]
    got = batcher.run()
    assert [got[r] for r in rids] == want
    assert not batcher.busy
    jeng = JaxGenerationEngine(*weights, wkv_backend="reference")
    jb = JaxContinuousBatcher(jeng, n_slots=2, sampling=JaxSamplingParams(**GREEDY),
                              block_size=block)
    jrids = [jb.submit(p, max_tokens=m, sampling=_sp(dict(k, **stops.get(i, {})), JaxSamplingParams))
             for i, (p, m, k) in enumerate(zip(PROMPTS, MAXES, KNOBS))]
    jgot = jb.run()
    assert [[int(t) for t in jgot[r]] for r in jrids] == want


@pytest.mark.parametrize("block", [1, 4])
def test_sampled_rows_run_beside_greedy_rows(engine, block):
    batcher = ContinuousBatcher(engine, n_slots=3, sampling=SP, block_size=block, seed=3)
    hot = _sp({"temperature": 1.0, "top_p": 0.9})
    r_hot = batcher.submit(PROMPTS[0], max_tokens=7, sampling=hot)
    r_greedy = batcher.submit(PROMPTS[1], max_tokens=7)
    got = batcher.run()
    assert len(got[r_hot]) == 7 and all(0 <= t < 1000 for t in got[r_hot])
    assert got[r_greedy] == engine.generate(PROMPTS[1], max_tokens=7, sampling=SP)
    again = ContinuousBatcher(engine, n_slots=3, sampling=SP, block_size=block, seed=3)
    r2 = again.submit(PROMPTS[0], max_tokens=7, sampling=hot)
    again.submit(PROMPTS[1], max_tokens=7)
    assert again.run()[r2] == got[r_hot]         # the seed fixes the draws


def test_submit_refuses_global_knobs_and_oversized_stop_sets(engine):
    batcher = ContinuousBatcher(engine, n_slots=1, sampling=SP, block_size=4, max_stop_tokens=2)
    with pytest.raises(ValueError, match="top_k"):
        batcher.submit([5], sampling=_sp({"top_k": 5}))
    with pytest.raises(ValueError, match="token_stop"):
        batcher.submit([5], sampling=_sp({"token_stop": (1, 2, 3)}))
    with pytest.raises(ValueError, match="unknown adapter"):
        batcher.submit([5], adapter="nope")


@pytest.mark.parametrize("block", [1, 4])
def test_cancel_queued_and_active(engine, block):
    batcher = ContinuousBatcher(engine, n_slots=1, sampling=SP, block_size=block)
    ra = batcher.submit([5, 9, 23], max_tokens=100)
    rb = batcher.submit([77, 3], max_tokens=100)
    rc = batcher.submit([14, 60], max_tokens=5)
    for _ in range(3):
        batcher.step()
    assert batcher.cancel(ra) and batcher.cancel(rb)
    got = batcher.run()
    assert set(got) == {ra, rb, rc}
    full_a = engine.generate([5, 9, 23], max_tokens=16, sampling=SP)
    assert 1 <= len(got[ra]) <= 12 and got[ra] == full_a[: len(got[ra])]
    assert got[rb] == []
    assert got[rc] == engine.generate([14, 60], max_tokens=5, sampling=SP)


def test_cancelling_the_sole_request_goes_idle(engine):
    batcher = ContinuousBatcher(engine, n_slots=2, sampling=SP, block_size=4)
    ra = batcher.submit([5, 9, 23], max_tokens=10_000)
    for _ in range(3):
        batcher.step()
    batcher.cancel(ra)
    got = batcher.run()              # terminates: the device row went inactive
    assert set(got) == {ra} and 1 <= len(got[ra]) < 10_000 and not batcher.busy


def test_grouped_admission_and_the_prefix_cache(weights, monkeypatch):
    """Same-length prompts share one batched prefill; with a prefix cache a
    repeated prompt resumes from its boundary state; outputs stay exact."""
    model = torch_model(*weights)
    plain = GenerationEngine(model)
    eng = GenerationEngine(model, state_cache=PrefixStateCache(16), chunk_len=8)
    pa = [5, 9, 23] + list(range(40, 57))
    pb = [7, 11, 29] + list(range(80, 97))
    want = [plain.generate(p, max_tokens=6, sampling=SP) for p in (pa, pb, pa)]
    batcher = ContinuousBatcher(eng, n_slots=3, sampling=SP, block_size=4)
    groups = []
    real = batcher._admit_group
    monkeypatch.setattr(batcher, "_admit_group",
                        lambda grp, slots, rem, aid: (groups.append((len(grp), rem)),
                                                      real(grp, slots, rem, aid)))
    rids = [batcher.submit(p, max_tokens=6) for p in (pa, pb)]
    got = batcher.run()
    assert groups == [(2, 19)]
    rids.append(batcher.submit(pa, max_tokens=6))
    got.update(batcher.run())
    assert [got[r] for r in rids] == want
    assert eng.state_cache.hits >= 1 and groups[-1][1] < 19


def test_adaptive_block_keeps_the_outputs(engine):
    want = _expected(engine)
    batcher = ContinuousBatcher(engine, n_slots=2, sampling=SP, block_size=16,
                                adaptive_block=True)
    assert batcher._block_sizes == [8, 16]
    rids = [batcher.submit(p, max_tokens=m, sampling=_sp(k))
            for p, m, k in zip(PROMPTS, MAXES, KNOBS)]
    got = batcher.run()
    assert [got[r] for r in rids] == want


def _stub(batcher_cls, sizes, slots):
    stub = batcher_cls.__new__(batcher_cls)
    stub._block_sizes, stub._slots = sizes, slots
    return stub


def test_pick_block_size_counts_a_slot_readmitted_since_dispatch():
    """rwkv_lm_ext_tpu/infer/continuous.py:464. Slot 0 ran the fetched block and has
    40 tokens left; slot 1's request finished in that block and a new one
    with 10 tokens of budget was admitted after it was dispatched. The next
    block must fit the new request (8), not skip it (16)."""
    old = _Request(0, [1], 5, SP)
    long_ = _Request(1, [1], 48, SP, out_ids=[0] * 4)
    new = _Request(2, [1], 10, SP)
    emitted, live = [4, 1], [1, 0]
    port = _stub(ContinuousBatcher, [8, 16], [long_, new])
    assert port._pick_block_size(emitted, live, [long_, old]) == 8
    # the JAX logic skips the re-admitted slot
    jax_stub = _stub(JaxContinuousBatcher, [8, 16], [long_, new])
    assert JaxContinuousBatcher._pick_block_size(jax_stub, emitted, live) == 16


def test_step_block_counts_whole_blocks(engine):
    """rwkv_lm_ext_tpu/infer/continuous.py:532: the block length read after the
    emission loop is the block's, not the loop's last index, so the decode
    steps counted are the blocks' lengths (the JAX code's shadowed ``k``
    would read K - 1 there)."""
    batcher = ContinuousBatcher(engine, n_slots=2, sampling=SP, block_size=4)
    dispatched = []
    real = batcher._run
    batcher._run = lambda key: (dispatched.append(key), real(key))[1]
    for p, m in zip(PROMPTS[:3], MAXES[:3]):
        batcher.submit(p, max_tokens=m)
    got = batcher.run()
    stats = batcher.stats()
    assert stats["blocks"] == len(dispatched) and stats["steps"] == 4 * len(dispatched)
    assert stats["emitted"] == sum(len(v) for v in got.values()) == sum(MAXES[:3])


def test_mixed_adapter_pool(weights):
    params, cfg = weights
    lc, jlc = LoraConfig(r=4, alpha=16.0), JaxLoraConfig(r=4, alpha=16.0)
    ads = {}
    for seed, name, scale in ((11, "chat", 0.05), (12, "embed", -0.05)):
        ad = jax_init_lora_params(jax.random.PRNGKey(seed), params, jlc)
        ads[name] = lora_tree_from_jax({k: {"A": v["A"], "B": scale * jnp.ones_like(v["B"])}
                                        for k, v in ad.items()})
    base = torch_model(params, cfg)
    slot, ids = build_slot_lora(copy.deepcopy(base), ads, lc)
    eng = GenerationEngine(slot, adapter_ids=ids)
    reqs = [([5, 9, 23], "chat"), ([5, 9, 23], None), ([77, 3], "embed"), ([14, 60], "chat"),
            ([99], None)]
    merged = {None: base, **{n: merge_lora(apply_lora(copy.deepcopy(base), lc, a))
                             for n, a in ads.items()}}
    want = [GenerationEngine(merged[a]).generate(p, max_tokens=5, sampling=SP) for p, a in reqs]
    assert want[0] != want[1]
    for block in (1, 4):
        batcher = ContinuousBatcher(eng, n_slots=2, sampling=SP, block_size=block)
        rids = [batcher.submit(p, max_tokens=5, adapter=a) for p, a in reqs]
        got = batcher.run()
        assert [got[r] for r in rids] == want, block


def test_per_request_initial_states(engine):
    rng = torch.Generator().manual_seed(8)
    cfg = engine.cfg
    st = engine.init_state(1, wkv_init=0.1 * torch.randn(cfg.n_layer, cfg.n_head, cfg.head_size,
                                                          cfg.head_size, generator=rng))
    want = engine.generate([5, 9, 23], max_tokens=6, sampling=SP, state=st)
    assert want != engine.generate([5, 9, 23], max_tokens=6, sampling=SP)
    for block in (1, 4):
        batcher = ContinuousBatcher(engine, n_slots=2, sampling=SP, block_size=block)
        r1 = batcher.submit([5, 9, 23], max_tokens=6, initial_state=st)
        r2 = batcher.submit([77, 3], max_tokens=6)
        got = batcher.run()
        assert got[r1] == want
        assert got[r2] == engine.generate([77, 3], max_tokens=6, sampling=SP)


def test_driver_serves_concurrent_callers_and_cancels(engine):
    want = [engine.generate(p, max_tokens=7, sampling=SP) for p in PROMPTS[:3]]
    batcher = ContinuousBatcher(engine, n_slots=2, sampling=SP, block_size=4)
    batcher.warmup()
    assert batcher.stats()["steps"] == 0 and not batcher.busy
    driver = BatcherDriver(batcher)
    try:
        results = [None] * 3

        def worker(i):
            results[i] = driver.submit_and_wait(PROMPTS[i], max_tokens=7, timeout=60)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads) and results == want
        gone = threading.Event()
        gone.set()
        partial = driver.submit_and_wait([5, 9, 23], max_tokens=10_000, cancel=gone, timeout=60)
        assert len(partial) < 10_000
        with pytest.raises(TimeoutError):
            driver.submit_and_wait([5, 9, 23], max_tokens=10_000, timeout=0.05)
    finally:
        driver.close()
    assert not driver._thread.is_alive()


def test_a_failing_step_reaches_every_waiter(engine, monkeypatch):
    """A step that raises stops the driver's thread, re-raised there, and
    every waiter raises instead of blocking."""
    seen = []
    monkeypatch.setattr(threading, "excepthook", lambda args: seen.append(args.exc_type))
    batcher = ContinuousBatcher(engine, n_slots=2, sampling=SP, block_size=4)

    def broken():
        raise ValueError("a broken step")

    monkeypatch.setattr(batcher, "step", broken)
    driver = BatcherDriver(batcher)
    with pytest.raises(RuntimeError, match="decode loop died"):
        driver.submit_and_wait([5, 9, 23], max_tokens=4, timeout=30)
    driver._thread.join(timeout=10)
    assert not driver._thread.is_alive() and seen == [ValueError]
    with pytest.raises(RuntimeError, match="decode loop died"):
        driver.submit_and_wait([5], max_tokens=1, timeout=30)
