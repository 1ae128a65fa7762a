"""Head-parallel tensor parallelism of the port (parallel/) against the JAX
package, on the CPU.

The layout: every leaf of a v6 tree (dense, int8, int8c, nf4) is split on the
axis that JAX's ``param_shardings`` names at tp=2 (on the 8 virtual CPU
devices of tests/conftest.py), in the port's (out, in) layout, with JAX's
divisibility guard; the shards put back together are the whole tensor.

Two ranks over gloo (tests/torch_tp_ranks.py, one spawned pair for the whole
module, a file rendezvous under the test's temporary directory; the JAX
references are computed while it runs) run a tiny
RWKV-6 (2 layers, C=64, H=4, N=16, vocab 128; the JAX weights of
torch_stack_setup.jax_params, whose zero-initialised projections get seeded
values, so the row-parallel att.output and ffn.value carry signal) and hold:
fp32 logits within 1e-5 of max of JAX's ``rwkv_forward``; greedy generation
equal to JAX's engine (test_parallel.py:370); a 2-slot batcher equal to JAX's
batcher (:397); int8 and nf4 engines equal to the single-process port and to
JAX's quantized engines (:424); int8c sharded bit-equal to single-process
int8c (the row-parallel codes and scales, the product and the logits); and an
RWKV-5.2 model against the single-process port. The JAX references run
single-device in this process: a tp layout is a layout, and JAX's own tests
hold its sharded results equal to single-device ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.adapters.quant import quantize_tree
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.infer.continuous import ContinuousBatcher as JaxContinuousBatcher
from rwkv_lm_ext_tpu.infer.engine import GenerationEngine as JaxGenerationEngine
from rwkv_lm_ext_tpu.infer.sampling import SamplingParams as JaxSamplingParams
from rwkv_lm_ext_tpu.models import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.parallel import make_mesh as jax_make_mesh
from rwkv_lm_ext_tpu.parallel import param_shardings
from rwkv_lm_ext_tpu_torch.adapters.quant import quantize_linear
from rwkv_lm_ext_tpu_torch.config import ModelConfig
from rwkv_lm_ext_tpu_torch.infer.continuous import _sampling_from_wire, _sampling_to_wire
from rwkv_lm_ext_tpu_torch.infer.engine import GenerationEngine
from rwkv_lm_ext_tpu_torch.infer.sampling import SamplingParams
from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.ops.quant import quantize_rows, quantize_rows_given
from rwkv_lm_ext_tpu_torch.parallel.distributed import broadcast_obj, process_count
from rwkv_lm_ext_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    quant_split,
    shard_state_dict,
    split_axis,
)
from rwkv_lm_ext_tpu_torch.parallel.tp import SlicedLinear, cut_projection, shard_model
from torch_stack_setup import jax_params, torch_model
from torch_tp_ranks import BATCH_PROMPTS, GREEDY, PROMPT, Pair

torch.set_num_threads(1)  # tier-1 runs several pytest workers

LIMIT = 1e-5


@pytest.fixture(scope="module")
def weights():
    return jax_params(seed=3, n_layer=2, n_embd=64, vocab_size=128, head_size=16)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(2).integers(0, 128, size=(2, 13))


def _v5_state_dict() -> dict:
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=128, head_size=16, version=5.2,
                      dtype="float32")
    gen = torch.Generator().manual_seed(5)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in [k for k in sd if k.endswith(("att.output.weight", "ffn.value.weight",
                                              "ffn.receptance.weight"))]:
        sd[key] = torch.randn(sd[key].shape, generator=gen) * (0.5 / sd[key].shape[1] ** 0.5)
    return sd


@pytest.fixture(scope="module")
def pair(weights, tokens, tmp_path_factory):
    """tests/torch_tp_ranks.py job_engine's two ranks, started."""
    d = tmp_path_factory.mktemp("tp_engine")
    sd = {k: torch.from_numpy(np.array(v)) for k, v in jax_params_to_state_dict(*weights).items()}
    torch.save({"sd": sd, "tokens": torch.from_numpy(tokens), "sd_v5": _v5_state_dict()},
               d / "inputs.pt")
    return Pair("engine", d)


@pytest.fixture(scope="module")
def jax_refs(pair, weights, tokens):
    """The JAX package's answers, single-device, computed while the ranks
    run: rwkv_forward's logits, the engine's greedy tokens (dense, int8,
    nf4) and the batcher's."""
    params, cfg = weights
    logits, _ = jax_rwkv_forward(params, cfg, jnp.asarray(tokens), wkv_backend="reference")
    jb = JaxContinuousBatcher(JaxGenerationEngine(params, cfg, wkv_backend="reference"),
                              n_slots=2, sampling=JaxSamplingParams(**GREEDY))
    rids = [jb.submit(p, max_tokens=4) for p in BATCH_PROMPTS]
    done = jb.run()
    return {"logits": np.asarray(logits), "greedy": _jax_greedy(params, cfg),
            "batcher": [done[r] for r in rids],
            **{mode: _jax_greedy(quantize_tree(params, mode=mode), cfg) for mode in ("int8", "nf4")}}


@pytest.fixture(scope="module")
def ranks(pair, jax_refs):
    """Both ranks' results."""
    return pair.results()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_greedy(params, cfg, max_tokens=8):
    return JaxGenerationEngine(params, cfg, wkv_backend="reference").generate(
        PROMPT, max_tokens=max_tokens, sampling=JaxSamplingParams(**GREEDY))


# -- on the spawned pair --------------------------------------------------------


def test_tp2_logits_match_jax_forward(ranks, jax_refs):
    r0, r1 = (r["fp32"]["logits"] for r in ranks)
    assert torch.equal(r0, r1)                     # every rank holds the same logits
    assert _rel(r0.numpy(), jax_refs["logits"]) <= LIMIT
    assert ranks[0]["fp32"]["wkv_shape"] == (2, 2, 2, 16, 16)   # (L, B, H/tp, N, N)


def test_tp2_greedy_matches_jax_engine(ranks, jax_refs):
    want = jax_refs["greedy"]
    assert ranks[0]["fp32"]["greedy"] == ranks[1]["fp32"]["greedy"] == want
    assert ranks[0]["fp32"]["single"]["greedy"] == want


def test_tp2_batcher_matches_jax_batcher(ranks, jax_refs):
    assert ranks[0]["fp32"]["batcher"] == ranks[1]["fp32"]["batcher"] == jax_refs["batcher"]


@pytest.mark.parametrize("mode", ["int8", "nf4"])
def test_tp2_quantized_engines_match_single_process_and_jax(ranks, jax_refs, mode):
    want = jax_refs[mode]
    got = ranks[0][mode]
    assert got["greedy"] == ranks[1][mode]["greedy"] == got["single"]["greedy"] == want
    assert _rel(got["logits"], got["single"]["logits"]) <= LIMIT


def test_tp2_int8c_is_bit_equal_to_single_process(ranks):
    for r in ranks:
        c = r["int8c_codes"]
        assert torch.equal(c["sx"], c["want_sx"]) and torch.equal(c["q"], c["want_q"])
        assert torch.equal(c["y"], ranks[0]["int8c_codes"]["want_y"])
        assert torch.equal(r["int8c"]["logits"], ranks[0]["int8c"]["single"]["logits"])
    assert ranks[0]["int8c"]["greedy"] == ranks[0]["int8c"]["single"]["greedy"]


def test_tp2_rwkv5_matches_single_process(ranks):
    got = ranks[0]["v5"]
    assert torch.equal(got["logits"], ranks[1]["v5"]["logits"])
    assert _rel(got["logits"], got["single"]["logits"]) <= LIMIT
    assert got["greedy"] == got["single"]["greedy"]


def test_tp2_route_is_reported(ranks):
    for rank, r in enumerate(ranks):
        assert r["fp32"]["route"] == {"device": "cpu", "blocks": "eager", "tp": 2, "rank": rank,
                                      "backend": "gloo"}


# -- in this process ----------------------------------------------------------


def _jax_leaf_key(keys) -> str:
    """The port's flat key of a JAX leaf path (the weight of a kernel)."""
    names = ["blocks" if k == "blocks" else str(k) for k in keys]
    return ".".join(names)


JAX_KERNELS = {"receptance", "key", "value", "gate", "output", "head"}


@pytest.mark.parametrize("mode", [None, "int8", "int8c", "nf4"])
def test_layout_matches_jax_param_shardings(weights, mode):
    """Each leaf's split axis (or none) as JAX's param_shardings names it at
    tp=2, mapped to the port's layout: a JAX (in, out) kernel axis a is the
    port's axis 1 - a, and an int8 scale (1, out) is the port's (out, 1).
    nf4: a row-parallel leaf's blocks split as in JAX; JAX splits a
    column-parallel leaf's packed bytes within each block (axis 1 of (blocks,
    32)), which the port does not do: it keeps whole blocks (quant_split)."""
    params, cfg = weights
    tree = params if mode is None else quantize_tree(params, mode=mode)
    shardings = param_shardings(tree, jax_make_mesh(dp=1, tp=2))
    sd = torch_model(params, cfg).state_dict()
    seen = 0
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        spec = tuple(sh.spec)
        jax_axis = next((i for i, n in enumerate(spec) if n == "tp"), None)
        quantized = mode is not None and isinstance(keys[-1], int) and keys[-2] in JAX_KERNELS
        if quantized:
            key = _jax_leaf_key(keys[:-1]) + ".weight"
            child = ("q", "scale")[keys[-1]]
            axis = split_axis(key, sd[key].shape, 2)
            if axis is None:
                assert jax_axis is None, key
                continue
            how = quant_split(mode, axis, tuple(sd[key].shape), 2)
            if mode in ("int8", "int8c"):
                # q: the port's (out, in) = the JAX q transposed; scale (out, 1)
                want = {("q", "rows"): 1, ("q", "cols"): 0,
                        ("scale", "rows"): 1, ("scale", "cols"): None}[(child, how)]
                assert jax_axis == want, (key, child, spec)
            elif axis == 1:                              # nf4, row-parallel
                assert how == "blocks" and jax_axis == 0, (key, child, spec)
            else:                                        # nf4, column-parallel
                assert jax_axis == (1 if child == "q" else None), (key, child, spec)
            seen += 1
            continue
        name = keys[-1]
        if keys[-2:] in (["ln_x", "scale"], ["ln_x", "bias"]):
            key = _jax_leaf_key(keys[:-1]) + (".weight" if name == "scale" else ".bias")
        elif name in ("scale", "bias"):
            continue                                     # LayerNorms: whole in both
        else:
            key = _jax_leaf_key(keys) + (".weight" if name in JAX_KERNELS | {"emb"} else "")
        shape = tuple(sd[key].shape)
        axis = split_axis(key, shape, 2)
        if name in JAX_KERNELS:
            want = None if jax_axis is None else 1 - jax_axis
        elif name == "time_decay":
            want = None if jax_axis is None else 2           # JAX (A,), the port's (1, 1, A)
        else:
            want = jax_axis
        assert axis == want, (key, spec, axis)
        seen += 1
    assert seen >= 20


def test_shards_put_back_together(weights):
    params, cfg = weights
    sd = dict(torch_model(params, cfg).state_dict())
    sd["blocks.0.att.time_faaaa_odd"] = torch.zeros(3, 16)     # no rule: whole
    odd = {"blocks.0.att.ln_x.weight": torch.ones(65)}          # 65 % 2: the guard keeps it whole
    parts = [shard_state_dict({**sd, **odd}, 2, r) for r in range(2)]
    for key, whole in {**sd, **odd}.items():
        axis = split_axis(key, tuple(whole.shape), 2)
        if axis is None:
            assert all(p[key] is whole for p in parts), key
        else:
            assert torch.equal(torch.cat([p[key] for p in parts], axis), whole), key
    assert split_axis("blocks.0.att.ln_x.weight", (65,), 2) is None
    assert split_axis("head.weight", (128, 64), 1) is None


@pytest.mark.parametrize("fmt", ["nf4", "fp4"])
@pytest.mark.parametrize("out_features,in_features,axis", [
    (256, 64, 0), (64, 256, 1),      # whole blocks for each rank
    (64, 64, 0), (32, 6, 1),         # blocks that would cross the boundary: kept whole
])
def test_4bit_projection_shards_dequantize_to_the_whole_weights_slices(
        fmt, out_features, in_features, axis):
    w = torch.randn(out_features, in_features, generator=torch.Generator().manual_seed(1))
    lin = quantize_linear(w, fmt)
    whole = lin.dequantize()
    for rank in range(2):
        part = cut_projection(lin, axis, Mesh(dp=1, tp=2, rank=rank))
        blocks = quant_split(fmt, axis, (out_features, in_features), 2) == "blocks"
        assert isinstance(part, SlicedLinear) != blocks
        w_rank = whole.chunk(2, axis)[rank]
        x = torch.randn(3, w_rank.shape[1])
        want = x @ w_rank.t()
        assert torch.allclose(part(x), want, atol=1e-6)


def test_quantize_rows_given_equals_quantize_rows_at_its_scale():
    x = torch.randn(5, 37, generator=torch.Generator().manual_seed(0)) * 3
    q, sx = quantize_rows(x)
    assert torch.equal(quantize_rows_given(x, sx), q)
    # a larger scale (another slice's) rounds the same way as the kernel
    wide = sx * 1.7
    assert torch.equal(quantize_rows_given(x, wide), torch.round(x / wide).to(torch.int8))
    with pytest.raises(ValueError, match="sx must be"):
        quantize_rows_given(x, sx[:2])


def test_refusals_by_name():
    with pytest.raises(ValueError, match="must be the number of processes"):
        make_mesh(dp=2)
    with pytest.raises(ValueError, match="must be the number of processes"):
        make_mesh(tp=2)
    tiny = RWKV(ModelConfig(n_layer=1, n_embd=32, vocab_size=64, head_size=16), device="cpu")
    with pytest.raises(ValueError, match="serving takes dp = 1"):
        GenerationEngine(tiny, mesh=Mesh(dp=2, tp=1, rank=0))
    assert make_mesh().tp == 1 and process_count() == 1
    mesh = Mesh(dp=1, tp=2, rank=0)
    v4 = RWKV(ModelConfig(n_layer=1, n_embd=32, vocab_size=64, head_size=32, version=4.0),
              device="cpu")
    with pytest.raises(ValueError, match="RWKV-4"):
        shard_model(v4, mesh)
    odd = RWKV(ModelConfig(n_layer=1, n_embd=48, vocab_size=64, head_size=16), device="cpu")
    with pytest.raises(ValueError, match="n_head"):
        shard_model(odd, mesh)
    model = RWKV(ModelConfig(n_layer=1, n_embd=64, vocab_size=64, head_size=16), device="cpu")
    with pytest.raises(ValueError, match="fused_prep is refused"):
        GenerationEngine(model, fused_prep=True, mesh=mesh)


def test_single_process_broadcast_and_the_sampling_wire():
    assert broadcast_obj({"a": [1, 2]}) == {"a": [1, 2]}
    sp = SamplingParams(temperature=0.5, token_ban=(3, 4), token_stop=(0, 7))
    assert _sampling_from_wire(_sampling_to_wire(sp)) == sp
    assert _sampling_to_wire(None) is None and _sampling_from_wire(None) is None
