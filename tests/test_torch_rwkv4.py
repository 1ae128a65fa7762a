"""The port's RWKV-4 family (CPU, the kernels' plain versions) against the
JAX package: ``wkv4_plain`` against JAX ``wkv4``, the model against
``rwkv4_forward`` on the same flat dict, the engine and the batcher against
the JAX argmax loop (tests/test_rwkv4.py:167-207 mirrored), and the serving
CLI with ``--tokenizer-json``.

The model is JAX's test model (tests/test_rwkv4.py: 2 layers, C=32, F=128,
vocab 100, fp32, random weights), carried over by ``params_to_state_dict``;
every JAX reference is computed once (module fixtures).

Tolerances (fp32): the WKV's y and state within 1e-5 of their largest value
(the same operations in the same order; the exponentials of two libraries);
logits and states within 1e-5 of theirs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.checkpoint.pth import save_torch_pth
from rwkv_lm_ext_tpu.checkpoint.pth import sniff_model_config as jax_sniff_model_config
from rwkv_lm_ext_tpu.infer.encoders import BiEncoder as JaxBiEncoder
from rwkv_lm_ext_tpu.models.rwkv4 import rwkv4_forward
from rwkv_lm_ext_tpu.ops.wkv4 import wkv4 as jax_wkv4
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    checkpoint_config,
    load_rwkv_checkpoint,
    load_state_dict_into,
    save_rwkv_checkpoint,
)
from rwkv_lm_ext_tpu_torch.checkpoint.pth import sniff_model_config
from rwkv_lm_ext_tpu_torch.data.tokenizer import WorldTokenizer
from rwkv_lm_ext_tpu_torch.infer.continuous import ContinuousBatcher
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.infer.states_registry import StatesRegistry
from rwkv_lm_ext_tpu_torch.models.decode import rwkv_decode_step
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.models.rwkv4 import TimeMixV4
from rwkv_lm_ext_tpu_torch.models.state import init_model_state, state_from_jax, state_to_jax
from rwkv_lm_ext_tpu_torch.ops import launch_counts
from rwkv_lm_ext_tpu_torch.ops.wkv4 import wkv4, wkv4_plain
from rwkv_lm_ext_tpu_torch.serve import cli as pcli
from tests.test_rwkv4 import CFG as JAX_CFG
from tests.test_rwkv4 import _v4_params

torch.set_num_threads(1)  # tier-1 runs several pytest workers

SNIFFED = ("n_layer", "n_embd", "vocab_size", "dim_att", "dim_ffn", "head_size", "version")
GREEDY = SamplingParams(temperature=0.0, top_p=1.0, alpha_presence=0.0, alpha_frequency=0.0,
                        token_stop=())
PROMPTS = ([5, 9, 23], [77, 3], [42])
NEW = 5
V4_KEYS = ("att_shift", "aa", "bb", "pp", "ffn_shift")


def assert_close(got, want, what, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def wkv_inputs(T, seed, *, state: bool, k_hi: float = 3.0):
    """k, v (B=2, T, C=24), w <= 0, u, and a carried state or None."""
    rng = np.random.default_rng(seed)
    k = rng.uniform(-3.0, k_hi, size=(2, T, 24)).astype(np.float32)
    v = rng.normal(size=(2, T, 24)).astype(np.float32)
    w = -np.exp(rng.normal(size=24)).astype(np.float32)
    u = rng.normal(size=24).astype(np.float32)
    s = None
    if state:
        s = (rng.normal(size=(2, 24)).astype(np.float32),
             np.exp(rng.normal(size=(2, 24))).astype(np.float32),
             rng.uniform(-5, 5, size=(2, 24)).astype(np.float32))
    return k, v, w, u, s


@pytest.mark.parametrize("T,state,k_hi", [(1, False, 3.0), (7, True, 3.0), (33, False, 60.0),
                                          (33, True, 60.0)])
def test_wkv4_plain_matches_jax(T, state, k_hi):
    """A fresh state (pp = -1e38: exp(pp - p) must give 0, not NaN), a
    carried one, and k up to +60 (the running max keeps exp in range)."""
    k, v, w, u, s = wkv_inputs(T, seed=T, state=state, k_hi=k_hi)
    want_y, want_s = jax_wkv4(jnp.asarray(k), jnp.asarray(v), jnp.asarray(w), jnp.asarray(u),
                              None if s is None else tuple(map(jnp.asarray, s)))
    ts = None if s is None else tuple(torch.from_numpy(x) for x in s)
    before = launch_counts()["wkv4"]
    y, st = wkv4(torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(w),
                 torch.from_numpy(u), ts)
    assert launch_counts()["wkv4"] == before            # CPU tensors take the plain version
    assert torch.isfinite(y).all() and y.dtype == torch.float32
    assert_close(y, want_y, "y")
    for name, a, b in zip(("aa", "bb", "pp"), st, want_s):
        assert_close(a, b, name)


def test_wkv4_plain_in_place_state():
    """out_state=state updates the state in place, to what a fresh output
    gets."""
    k, v, w, u, s = wkv_inputs(5, seed=3, state=True)
    args = [torch.from_numpy(x) for x in (k, v, w, u)]
    y, fresh = wkv4_plain(*args, tuple(torch.tensor(x) for x in s))
    state = tuple(torch.tensor(x) for x in s)
    y2, out = wkv4_plain(*args, state, out_state=state)
    assert all(o is i for o, i in zip(out, state))
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    for a, b in zip(out, fresh):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.fixture(scope="module")
def v4():
    """(flat dict, port model, JAX params, tokens, JAX references)."""
    params = _v4_params(jax.random.PRNGKey(0), JAX_CFG)
    sd = jax_params_to_state_dict(params, JAX_CFG)
    model = load_state_dict_into(RWKV(checkpoint_config(sd, dtype="float32"), device="cpu"), sd)
    tokens = np.random.default_rng(5).integers(0, 100, size=(2, 10))
    full, state = rwkv4_forward(params, JAX_CFG, jnp.asarray(tokens))
    _, state6 = rwkv4_forward(params, JAX_CFG, jnp.asarray(tokens[:, :6]))
    step, state7 = rwkv4_forward(params, JAX_CFG, jnp.asarray(tokens[:, 6:7]), state6)

    def greedy(prompt):
        logits, st = rwkv4_forward(params, JAX_CFG, jnp.asarray([prompt]))
        out = []
        for _ in range(NEW):
            out.append(int(jnp.argmax(logits[0, -1])))
            logits, st = rwkv4_forward(params, JAX_CFG, jnp.asarray([[out[-1]]]), st)
        return out

    np_state = lambda st: {k: np.asarray(v) for k, v in st.items()}
    ref = dict(full=np.asarray(full), state=np_state(state), state6=np_state(state6),
               step=np.asarray(step), state7=np_state(state7),
               greedy=[greedy(p) for p in PROMPTS])
    return sd, model, params, tokens, ref


def test_v4_sniff_and_model_match_jax(v4):
    sd, model, _, tokens, ref = v4
    got, want = sniff_model_config(sd), jax_sniff_model_config(sd)
    assert {f: getattr(got, f) for f in SNIFFED} == {f: getattr(want, f) for f in SNIFFED}
    assert model.cfg.version == 4.0 and isinstance(model.blocks[1].att, TimeMixV4)
    with torch.no_grad():
        logits, state = model(torch.from_numpy(tokens))
    assert logits.dtype == torch.float32 and tuple(state) == V4_KEYS
    # a v4 state has no wkv to unpack or pack: the same arrays both ways
    round_trip = state_to_jax(state_from_jax(ref["state"], head_size=32))
    assert all(np.array_equal(round_trip[k], ref["state"][k]) for k in V4_KEYS)
    assert_close(logits, ref["full"], "logits")
    for key in V4_KEYS:
        assert_close(state[key], ref["state"][key], key)


def test_v4_chunked_prefill_and_step_match_jax(v4):
    """Prefill in two calls carries the state; the T=1 step (B.14's plain
    version, in place) matches rwkv4_forward at T=1."""
    _, model, _, tokens, ref = v4
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        first, state = model(t[:, :6])
        rest, _ = model(t[:, 6:], state)
        assert_close(torch.cat([first, rest], 1), ref["full"], "chunked logits")
        for key in V4_KEYS:
            assert_close(state[key], ref["state6"][key], key)
        logits, out = rwkv_decode_step(model, t[:, 6], state, out=state)
    assert out is state
    assert_close(logits, ref["step"][:, 0], "step logits")
    for key in V4_KEYS:
        assert_close(state[key], ref["state7"][key], key)


def test_v4_refuses_hidden_states_and_named_states(v4):
    _, model, *_ = v4
    tok = torch.zeros(1, 3, dtype=torch.int64)
    with pytest.raises(ValueError, match="RWKV-4"):
        model(tok, return_hidden=True)
    with pytest.raises(ValueError, match="RWKV-4"):
        init_model_state(model.cfg, 1, device="cpu", wkv_init=torch.zeros(2, 1, 32, 32))
    with pytest.raises(ValueError, match="RWKV-4"):
        StatesRegistry(model.cfg, device="cpu")
    with pytest.raises(ValueError, match="fused_prep"):
        rwkv_decode_step(model, tok[:, 0], fused_prep=True)
    st = init_model_state(model.cfg, 2, device="cpu")
    assert tuple(st) == V4_KEYS and (st["pp"] == -1e38).all() and not st["aa"].any()


def test_v4_generation_through_engine_equals_jax(v4):
    _, model, _, _, ref = v4
    engine = GenerationEngine(model, chunk_len=2)
    for prompt, want in zip(PROMPTS, ref["greedy"]):
        assert engine.generate(prompt, max_tokens=NEW, sampling=GREEDY) == want
        assert engine.generate(prompt, max_tokens=NEW, sampling=GREEDY, block_size=1) == want


@pytest.mark.parametrize("block_size", [1, 4])
def test_v4_continuous_batching_equals_jax(v4, block_size):
    """The batcher's state scatter on aa, bb and pp: three requests over two
    slots (a slot is re-admitted; a one-token prompt starts from a fresh
    state, pp = -1e38), each the JAX argmax loop's tokens."""
    _, model, _, _, ref = v4
    batcher = ContinuousBatcher(GenerationEngine(model), n_slots=2, sampling=GREEDY,
                                block_size=block_size)
    rids = [batcher.submit(p, max_tokens=NEW) for p in PROMPTS]
    results = batcher.run()
    assert [results[r] for r in rids] == ref["greedy"]


def test_v4_checkpoint_round_trip(v4, tmp_path):
    sd, model, _, tokens, _ = v4
    path = str(tmp_path / "v4.pth")
    save_rwkv_checkpoint(model, path)
    loaded, cfg = load_rwkv_checkpoint(path, device="cpu", dtype="float32")
    assert cfg == model.cfg
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        np.testing.assert_array_equal(loaded(t)[0].numpy(), model(t)[0].numpy())


def _json_tokenizer(tmp_path):
    tokenizers = pytest.importorskip("tokenizers")
    tk = tokenizers.Tokenizer(tokenizers.models.BPE())
    tk.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False)
    tk.decoder = tokenizers.decoders.ByteLevel()
    tk.train_from_iterator(["hello world"] * 4, tokenizers.trainers.BpeTrainer(
        vocab_size=300, initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet()))
    path = str(tmp_path / "tokenizer.json")
    tk.save(path)
    return tk, path


def test_serve_cli_v4_with_json_tokenizer(tmp_path):
    """A v4 Pile-style deployment through the serving CLI on the CPU: a v4
    .pth (sniffed as 4.0) and an HF tokenizer.json (JAX
    tests/test_serve_cli.py:147-190); /generate answers text, and /embed
    answers 404 (no bi-encoder is configured)."""
    tk, tok_path = _json_tokenizer(tmp_path)
    import dataclasses

    cfg = dataclasses.replace(JAX_CFG, vocab_size=tk.get_vocab_size() + 8)
    model_pth = str(tmp_path / "v4.pth")
    save_torch_pth(model_pth, jax_params_to_state_dict(_v4_params(jax.random.PRNGKey(1), cfg), cfg))
    svc = pcli.build_service(pcli.parse_args([
        "--model", model_pth, "--dtype", "float32", "--platform", "cpu",
        "--tokenizer-json", tok_path, "--batcher-slots", "2"]))
    try:
        assert svc.engine.cfg.version == 4.0
        out = svc.handle("/generate", {"prompt": "hello", "max_tokens": 3, "temperature": 0.0,
                                       "token_stop": []})
        assert isinstance(out["output"], str)
        assert "/embed" not in svc.routes
    finally:
        svc.close()


def test_v4_embeddings_refused_as_jax_cannot_give_them(v4, tmp_path):
    """The JAX CLI builds a bi-encoder on a v4 model and stops at
    rwkv_forward's assertion when it embeds; the port's CLI refuses
    --bi-adapter, --cross-adapter and --states-config on a v4 .pth at
    start-up, by name."""
    _, _, params, _, _ = v4
    bi = JaxBiEncoder(params, JAX_CFG, WorldTokenizer())
    with pytest.raises(AssertionError):
        bi.encode_texts(["hello"])
    path = str(tmp_path / "v4.pth")
    save_torch_pth(path, jax_params_to_state_dict(params, JAX_CFG))
    for flag in ("--bi-adapter", "--cross-adapter", "--states-config"):
        with pytest.raises(SystemExit, match="RWKV-4"):
            pcli.build_service(pcli.parse_args(["--model", path, "--platform", "cpu",
                                                flag, str(tmp_path / "unused")]))


def test_v4_prefix_cache_and_beam_search(v4):
    """The prefix state cache and beam search walk the v4 state's keys: a
    prompt resumed from a cached prefix generates the cold prompt's tokens,
    and one greedy beam is the engine's greedy generation."""
    from rwkv_lm_ext_tpu_torch.infer.beam import BeamParams, generate_beamsearch
    from rwkv_lm_ext_tpu_torch.infer.state_cache import PrefixStateCache

    _, model, _, _, ref = v4
    cached = GenerationEngine(model, chunk_len=2, state_cache=PrefixStateCache(capacity=8))
    prompt = PROMPTS[0] + [11, 12, 13]
    cold = GenerationEngine(model, chunk_len=2).generate(prompt, max_tokens=NEW, sampling=GREEDY)
    assert cached.generate(PROMPTS[0], max_tokens=NEW, sampling=GREEDY) == ref["greedy"][0]
    assert cached.generate(prompt, max_tokens=NEW, sampling=GREEDY) == cold
    beams = generate_beamsearch(cached, PROMPTS[1], BeamParams(
        num_beams=1, num_groups=1, return_num_sequences=1, max_tokens=NEW, eos_ids=(),
        repetition_penalty=1.0, do_sample=False))
    assert beams[0][1] == ref["greedy"][1]
