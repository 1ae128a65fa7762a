"""Shared set-up of the parity tests (tests/test_torch_*.py): a small RWKV-6
built by the JAX package and carried into the port with checkpoint.convert,
both in fp32, so the two run the same weights; and the harness that holds
the port's contrastive trainers against the JAX commands
(``check_trainer_against_jax``, TRAINER_DOC)."""
import contextlib
import functools
import importlib
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rwkv_lm_ext_tpu import ModelConfig as JaxModelConfig
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.models import init_rwkv_params as jax_init_rwkv_params
from rwkv_lm_ext_tpu.train import cli as jcli
from rwkv_lm_ext_tpu.train.optim import decay_mask as jax_decay_mask
from rwkv_lm_ext_tpu.train.optim import lr_scale_labels as jax_lr_scale_labels
from rwkv_lm_ext_tpu.adapters import LoraConfig as JaxLoraConfig
from rwkv_lm_ext_tpu.adapters import pissa_init as jax_pissa_init
from rwkv_lm_ext_tpu_torch.adapters.lora import LoraLinear, lora_modules
from rwkv_lm_ext_tpu_torch.adapters.quant import quantize_linear, quantize_model
from rwkv_lm_ext_tpu_torch.adapters.slot_lora import SlotLoraLinear
from rwkv_lm_ext_tpu_torch.checkpoint.convert import (
    checkpoint_config,
    load_state_dict_into,
    one_layer_decoder_from_jax,
)
from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
from rwkv_lm_ext_tpu_torch.train import cli as pcli

# greedy without penalties or stops, as both packages spell it
GREEDY = dict(temperature=0.0, top_p=1.0, alpha_presence=0.0, alpha_frequency=0.0,
              token_stop=())


def jax_params(seed: int = 0, *, n_layer: int = 2, n_embd: int = 128, vocab_size: int = 1000,
               head_size: int = 64):
    """(params, cfg) of a JAX model whose zero-initialised projections get
    seeded values (else every block is a no-op)."""
    cfg = JaxModelConfig(n_layer=n_layer, n_embd=n_embd, vocab_size=vocab_size,
                         head_size=head_size, dtype="float32", param_dtype="float32")
    params = jax_init_rwkv_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for tree, name in ((bp["att"], "output"), (bp["ffn"], "value"), (bp["ffn"], "receptance")):
            shape = tree[name].shape
            tree[name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[0]), jnp.float32)
    return params, cfg


def seeded_weights(seed: int, *, n_layer: int = 2, n_embd: int = 128, vocab_size: int = 1000,
                   head_size: int = 64):
    """(port state dict, JAX params, JAX cfg): ``_params``' geometry and
    filling (the zero-initialised projections and the low-rank mixers
    seeded), drawn by the port's initialiser and numpy and carried into the
    JAX tree with ``state_dict_to_params``, so that no JAX op compiles for
    it. fp32."""
    from rwkv_lm_ext_tpu.checkpoint.convert import state_dict_to_params
    from rwkv_lm_ext_tpu_torch.config import ModelConfig
    from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params

    shape = dict(n_layer=n_layer, n_embd=n_embd, vocab_size=vocab_size, head_size=head_size)
    sd = init_rwkv_params(ModelConfig(**shape, dtype="float32"),
                          generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    for key in sd:
        if key.endswith(("att.output.weight", "ffn.value.weight", "ffn.receptance.weight",
                         "time_maa_w1", "time_maa_w2", "time_decay_w1", "time_decay_w2")):
            fan_in = sd[key].shape[-1] if key.endswith(".weight") else sd[key].shape[-2]
            sd[key] = torch.from_numpy(rng.normal(size=tuple(sd[key].shape)) * 0.5
                                       / np.sqrt(fan_in)).float()
    jcfg = JaxModelConfig(**shape, dtype="float32", param_dtype="float32")
    return sd, state_dict_to_params({k: v.numpy() for k, v in sd.items()}, jcfg), jcfg


def torch_model(params, cfg):
    """The port's model on the same weights, fp32, on the CPU (any family:
    ``checkpoint_config`` tells v5.0 from its missing gate)."""
    sd = jax_params_to_state_dict(params, cfg)
    return load_state_dict_into(RWKV(checkpoint_config(sd, dtype="float32"), device="cpu"), sd)


# ---------------------------------------------------------------------------
# The contrastive trainers against the JAX commands
# ---------------------------------------------------------------------------

TRAINER_DOC = """The parity tests run each command of both CLIs (``main([...])``) on the
same data files, with the checkpoint loader replaced by the same fp32
weights (tests/torch_stack_setup.py: 2 layers, n_embd 128) and the training
loop replaced by a probe; per-block remat off on both sides (its gradients
equal remat on's, tests/test_torch_train.py; the CLI tests run it on), one
world tokenizer a package. The probe compares the two pipelines batch for
batch (epochs 0 and 1), carries the JAX command's freshly initialised
trainables (LoRA factors, heads, the RetroMAE decoder) into the port's
model, then runs two steps of each command's own step function on the same
batches, the JAX side on its sequential reference WKV (``auto`` resolved to
``reference``: the recurrence the port's plain versions run; its chunked
factoring moves gradients by ~1e-5, which Adam's per-element normalisation
turns into a different second step): loss at rtol 1e-5 and grad_norm at
rtol 1e-4; each trainable parameter's optimizer group (lr multiplier,
weight decay) that of its JAX leaf (weight decay 2.0); the heads and
adapters moved, and after the steps within 1e-5 of their largest value or
half the lr, whichever is larger (Adam's first step is lr * g / |g| an
element: where a gradient is near zero its rounding decides the step).
The world tokenizer emits ids up to 65535: the steps run on the batches with
every id above 2 folded into the model's 1000 (both sides alike)."""
VOCAB = 1000
LR = 5e-5


def _write(path, rows):
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return str(path)


def contrastive_data(d):
    """One small file a data format of the contrastive trainers under the
    directory `d` (a pathlib.Path), rows of a few lengths (two buckets for
    the triplets): {format: path}."""
    words = "cats dogs birds fish trees rivers stones clouds".split()

    def text(i, n):
        return " ".join(words[(i + j) % len(words)] for j in range(n))

    files = {
        "triplet": _write(d / "triplet.jsonl", [
            {"query": text(i, 3 + 25 * (i % 3 == 0)), "positive": text(i + 1, 4),
             "negative": [text(i + 2, 2), text(i + 3, 5)]} for i in range(9)]),
        "pair": _write(d / "pair.jsonl", [
            {"query": text(i, 3), "document": text(i + 4, 6 + i), "label": i % 2}
            for i in range(6)]),
        "simcse": _write(d / "simcse.jsonl", [
            {"sentence_a": text(i, 4), "sentence_b": text(i + 1, 5)} for i in range(6)]),
        "instructor": _write(d / "instructor.jsonl", [
            {"instruction": "Represent the sentence: ", "query": text(i, 3),
             "positive": text(i + 1, 3), "negative": text(i + 5, 4)} for i in range(6)]),
        "documents": _write(d / "documents.jsonl", [
            {"query": text(i, 2), "documents": [text(i + j, 3 + j) for j in range(3 - (i == 2))]}
            for i in range(6)]),
        "text": _write(d / "text.jsonl", [{"text": text(i, 5 + i)} for i in range(6)]),
    }
    nli = d / "allnli.tsv"
    with open(nli, "w") as f:
        f.write("split\tdataset\tfilename\tsentence1\tsentence2\tlabel\n")
        for i in range(6):
            for label, j in (("entailment", 1), ("contradiction", 2), ("neutral", 3),
                             ("entailment", 4)):
                f.write(f"train\tSNLI\tx\t{text(i, 4)}\t{text(i + j, 3 + j)}\t{label}\n")
        f.write(f"dev\tSNLI\tx\t{text(0, 4)}\t{text(1, 3)}\tentailment\n")
    files["nli"] = str(nli)
    sts = d / "sts.tsv"
    with open(sts, "w") as f:
        f.write("split\tgenre\tdataset\tyear\tsid\tscore\tsentence1\tsentence2\n")
        for i in range(6):
            f.write(f"dev\tmain\tx\t2012\t{i}\t{i % 5}.5\t{text(i, 4)}\t{text(i + 1, 4)}\n")
    files["sts"] = str(sts)
    return files


# command, data file, extra flags: the cases of check_trainer_against_jax
TRAINER_CASES = [
    ("bi-encoder", "triplet", []),
    ("bi-encoder", "triplet", ["--loss", "cosent"]),
    ("cross-encoder", "pair", []),
    ("nli", "nli", ["--max-seq-len", "64"]),
    ("nli", "nli", ["--in-batch-negative"]),
    ("simcse", "simcse", []),
    ("instructor", "instructor", ["--output-dim", "32"]),
    ("encoder-biencoder", "triplet", ["--bi-mode", "fused"]),
    ("encoder-crossencoder", "documents", ["--group-size", "3"]),
    ("mae", "text", ["--uni"]),
]


def _params(seed):
    """The shared fixture's weights with the low-rank mixers filled too
    (the initialiser leaves them at zero or 1e-4): every gradient then
    stands well above rounding, which a comparison of Adam steps over every
    parameter needs (as in tests/test_torch_mlm_train.py)."""
    params, cfg = jax_params(seed=seed)
    rng = np.random.default_rng(seed)
    for bp in params["blocks"]:
        for name in ("time_maa_w1", "time_maa_w2", "time_decay_w1", "time_decay_w2"):
            shape = bp["att"][name].shape
            bp["att"][name] = jnp.asarray(rng.normal(size=shape) * 0.5 / np.sqrt(shape[-2]),
                                          jnp.float32)
    return params, cfg


def _fold(batch):
    """Every token id above 2 folded into the model's vocabulary (pad 0,
    emb / cls 1, sep 2 and the -100 labels stay)."""
    return {k: (np.where(v > 2, 3 + (v - 3) % (VOCAB - 3), v).astype(v.dtype)
                if v.dtype.kind == "i" else v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
            for k, v in batch.items()}


def _set(param, value):
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(value, np.float32)).reshape(param.shape))


def _carry_trainables(command, init, model, cfg, rng):
    """The JAX command's initial trainables into the port model; LoRA B gets
    seeded values on both sides (at 0 every dA would be 0). Returns the JAX
    tree to start from and {port name: JAX leaf path} of what to compare
    after the steps."""
    track = {}
    if command in ("bi-encoder", "cross-encoder"):
        adapter = init if command == "bi-encoder" else init["adapter"]
        adapter = {k: {"A": ab["A"], "B": jnp.asarray(rng.normal(size=ab["B"].shape) * 0.05,
                                                      jnp.float32)}
                   for k, ab in adapter.items()}
        for name, m in lora_modules(model):
            _set(m.lora_A, adapter[name]["A"])
            _set(m.lora_B, adapter[name]["B"])
            prefix = (name,) if command == "bi-encoder" else ("adapter", name)
            track[f"{name}.lora_A"] = prefix + ("A",)
            track[f"{name}.lora_B"] = prefix + ("B",)
        init = adapter if command == "bi-encoder" else {"adapter": adapter, "score": init["score"]}
    if command in ("cross-encoder", "encoder-crossencoder"):
        _set(model.score.weight, np.asarray(init["score"]["kernel"]).T)
        track["score.weight"] = ("score", "kernel")
    if command == "instructor":
        head = init["head"]
        _set(model.dense.weight, np.asarray(head["dense"]["kernel"]).T)
        _set(model.dense.bias, head["dense"]["bias"])
        _set(model.ln_dense.weight, head["ln"]["scale"])
        _set(model.ln_dense.bias, head["ln"]["bias"])
        track.update({"dense.weight": ("head", "dense", "kernel"), "dense.bias": ("head", "dense", "bias"),
                      "ln_dense.weight": ("head", "ln", "scale"), "ln_dense.bias": ("head", "ln", "bias")})
    if command == "mae":
        dec = one_layer_decoder_from_jax(init["onelayer_decoder"], model.cfg)
        model.onelayer_decoder.load_state_dict(dec.state_dict())
    return init, track


def _port_groups(optimizer, model):
    """{name: (lr multiplier, decays)} of the port optimizer's groups."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: (g["mult"], g["weight_decay"] > 0)
            for g in optimizer.opt.param_groups for p in g["params"]}


def _jax_groups(tree, jcfg, cfg):
    """{port name: (lr multiplier, decays)} of the JAX optimizer's rules
    (lr_scale_labels, decay_mask) on a command's trainable tree: each leaf
    coded as an array of +-multiplier (negative where it decays), carried
    to the port's names as the weights are."""
    mult = {"1x": 1.0, "2x": 2.0, "3x": 3.0}
    code = jax.tree_util.tree_map(
        lambda p, label, decays: np.full(np.shape(p), -mult[label] if decays else mult[label],
                                         np.float32),
        tree, jax_lr_scale_labels(tree), jax_decay_mask(tree))
    flat = {}
    if "blocks" in code or "model" in code:
        model = code.get("model", code)
        flat.update(jax_params_to_state_dict(model, jcfg))
        if "onelayer_decoder" in model:
            dec = one_layer_decoder_from_jax(model["onelayer_decoder"], cfg)
            flat.update({f"onelayer_decoder.{k}": v.numpy() for k, v in dec.state_dict().items()})
    else:
        for key, ab in code.get("adapter", code).items():
            flat[f"{key}.lora_A"], flat[f"{key}.lora_B"] = ab["A"], ab["B"]
    # the heads beside the model or the adapter
    heads = code if ("model" in code or "adapter" in code) else {}
    if "score" in heads:
        flat["score.weight"] = heads["score"]["kernel"]
    if "head" in heads:
        head = heads["head"]
        flat.update({"dense.weight": head["dense"]["kernel"], "dense.bias": head["dense"]["bias"],
                     "ln_dense.weight": head["ln"]["scale"], "ln_dense.bias": head["ln"]["bias"]})
    out = {}
    for name, v in flat.items():
        v = np.asarray(v).reshape(-1)
        assert (v == v[0]).all(), name
        out[name] = (float(abs(v[0])), bool(v[0] < 0))
    return out


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree, np.float64)


jwkv = importlib.import_module("rwkv_lm_ext_tpu.ops.wkv")    # the module, not the function
_resolve = jwkv._resolve_backend


def _reference_wkv(backend, T):
    return _resolve("reference" if backend == "auto" else backend, T)


_TOKENIZERS = {}


def _tokenizer(cls):
    """One `cls` world tokenizer for every command (loading the vocabulary
    takes seconds)."""
    def make(path=None):
        if cls not in _TOKENIZERS:
            _TOKENIZERS[cls] = cls(path)
        return _TOKENIZERS[cls]

    return make


def check_trainer_against_jax(data, tmp_path, command, fmt, extra, params=None):
    """Run `command` of both trainer CLIs on data[fmt] and hold them
    together (TRAINER_DOC); ``params`` ((JAX params, JAX cfg)) replaces the
    RWKV-6 fixture's weights."""
    jtok = importlib.import_module("rwkv_lm_ext_tpu.data.tokenizer")
    with mock.patch.object(jwkv, "_resolve_backend", _reference_wkv), \
            mock.patch.object(jtok, "WorldTokenizer", _tokenizer(jtok.WorldTokenizer)), \
            mock.patch.object(pcli, "WorldTokenizer", _tokenizer(pcli.WorldTokenizer)):
        _check_trainer(data, tmp_path, command, fmt, extra, params)


def _check_trainer(data, tmp_path, command, fmt, extra, given=None):
    params, jcfg = given or _params(len(command) + len(extra))
    argv = [command, *extra, "--model", "unused.pth", "--train-data", data[fmt], "--output-dir",
            str(tmp_path), "--micro-bsz", "2", "--ctx-len", "64", "--lr-init", str(LR),
            "--warmup-steps", "0", "--weight-decay", "2.0", "--seed", "3",
            "--grad-checkpoint", "off"]
    jax_run, port_run, made = {}, {}, {}

    def jax_loop(args, cfg, tc, init, step_fn, init_fn, batches, **kw):
        jax_run.update(init=init, step_fn=step_fn, init_fn=init_fn, batches=batches,
                       frozen=kw.get("frozen"))

    def port_load(path, *, device, **kw):
        made["model"] = torch_model(params, jcfg)
        return made["model"], made["model"].cfg

    def port_loop(args, tc, step_fn, batches, save_fn, device, eval_fn=None):
        port_run.update(step_fn=step_fn, batches=batches)

    with mock.patch.object(jcli, "_load_base", lambda args: (dict(params), jcfg)), \
            mock.patch.object(jcli, "_run_loop", jax_loop):
        jcli.main(argv)
    with mock.patch.object(pcli, "load_rwkv_checkpoint", port_load), \
            mock.patch.object(pcli, "_run_loop", port_loop):
        pcli.main(argv + ["--platform", "cpu"])

    # the pipelines, batch for batch
    batches = []
    for epoch in (0, 1):
        got, want = list(port_run["batches"](epoch)), list(jax_run["batches"](epoch))
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
        batches = batches or want

    model = made["model"]
    init, track = _carry_trainables(command, jax_run["init"], model, jcfg,
                                    np.random.default_rng(5))
    ts = jax_run["init_fn"](init)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if n in track}
    for batch in batches[:2]:
        batch = _fold(batch)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if jax_run["frozen"] is not None:
            ts, jm = jax_run["step_fn"](ts, jb, jax_run["frozen"])
        else:
            ts, jm = jax_run["step_fn"](ts, jb)
        m = port_run["step_fn"](_tb(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    named = dict(model.named_parameters())
    for name, path in track.items():
        got, want = named[name].detach().double().numpy(), _leaf(ts.params, path)
        want = want.T if name == "score.weight" or name == "dense.weight" else want
        assert not torch.equal(named[name].detach(), before[name]), f"{name} did not train"
        err = np.abs(got - want.reshape(got.shape)).max()
        assert err <= max(1e-5 * np.abs(want).max(), 0.5 * LR), (name, err)
    assert _port_groups(port_run["step_fn"].optimizer, model) == _jax_groups(
        jax_run["init"] if command not in ("bi-encoder", "cross-encoder") else init, jcfg, model.cfg)



# ---------------------------------------------------------------------------
# The SFT command against the JAX command
# ---------------------------------------------------------------------------

SFT_DOC = """``check_sft_against_jax`` runs ``sft`` of both trainer CLIs on the same
jsonl (TRAINER_DOC's set-up: the loaders replaced by the same fp32 weights,
the loops by a probe, remat off unless `extra` names a policy, the JAX WKV on
its sequential reference),
compares the pipelines batch for batch, carries the JAX command's initial
trainables into the port's model (LoRA B, and slot-LoRA's task rows of B,
seeded on both sides; PiSSA's deflated base and SVD adapter; the full
model's weights are the same already), and runs three steps of each
command's own step function: loss at rtol 1e-5, grad_norm at rtol 1e-4, the
trainables after the steps within 1e-5 of their largest value or half the
lr (``rtol`` and ``compare_params`` loosen these where a test says why).
``ste=True`` runs the JAX side with the test-built straight-through int8c
VJP (``ste_int8_mm``) in place of the package's own (ROADMAP C.18)."""


def sft_data(d, n: int = 8, tasks=None):
    """An SFT jsonl of `n` rows in the 64 bucket under the directory `d`;
    with `tasks`, row i carries tasks[i % len(tasks)]."""
    words = "the quick brown fox jumps over a lazy dog near rivers and stones".split()
    rows = []
    for i in range(n):
        row = {"instruction": "Continue", "input": " ".join(words[i % 5: i % 5 + 4]),
               "output": " ".join(words[(i + j) % len(words)] for j in range(5 + i % 4))}
        if tasks:
            row["task"] = tasks[i % len(tasks)]
        rows.append(row)
    return _write(d / ("sft_tasks.jsonl" if tasks else "sft.jsonl"), rows)


jquant = importlib.import_module("rwkv_lm_ext_tpu.adapters.quant")


def ste_int8_mm():
    """A jax.custom_vjp over the JAX package's own int8c forward (the XLA
    composition ``_int8_mm_impl``) with the ``int8`` mode's backward, dx = g
    @ dequantize(q, scale)^T: the straight-through reference of the port's
    int8c backward. The weight and its scale get zero gradients."""
    @functools.partial(jax.custom_vjp, nondiff_argnums=(3,))
    def mm(x, q, scale, dtype):
        return jquant._int8_mm_impl(x, q, scale, dtype, False)

    def fwd(x, q, scale, dtype):
        return mm(x, q, scale, dtype), (q, scale)

    def bwd(dtype, res, g):
        q, scale = res
        w = (q.astype(jnp.float32) * scale).astype(g.dtype)
        return g @ w.T, np.zeros(q.shape, jax.dtypes.float0), jnp.zeros_like(scale)

    mm.defvjp(fwd, bwd)
    return mm


def check_sft_against_jax(data_path, tmp_path, extra, *, ste=False, steps=3, seed=0,
                          rtol=(1e-5, 1e-4), compare_params=True, params=None):
    """Run ``sft`` `extra` of both CLIs on `data_path` and hold them
    together (SFT_DOC). ``params`` ((JAX params, JAX cfg)) replaces the
    RWKV-6 fixture's weights (another family's). Returns the port model
    after the steps."""
    jtok = importlib.import_module("rwkv_lm_ext_tpu.data.tokenizer")
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(jwkv, "_resolve_backend", _reference_wkv))
        stack.enter_context(mock.patch.object(jtok, "WorldTokenizer",
                                              _tokenizer(jtok.WorldTokenizer)))
        stack.enter_context(mock.patch.object(pcli, "WorldTokenizer",
                                              _tokenizer(pcli.WorldTokenizer)))
        if ste:
            stack.enter_context(mock.patch.object(jquant, "_int8_mm", ste_int8_mm()))
        return _check_sft(data_path, tmp_path, extra, steps, seed, rtol, compare_params, params)


def _opt(extra, flag, default=None):
    return extra[extra.index(flag) + 1] if flag in extra else default


def _check_sft(data_path, tmp_path, extra, steps, seed, rtol, compare_params, given=None):
    params, jcfg = given or _params(seed)
    train_type = _opt(extra, "--train-type", "lora")
    quant = _opt(extra, "--quant", "none")
    # `extra` last: its --grad-checkpoint, where it has one, wins
    argv = ["sft", "--model", "unused.pth", "--train-data", data_path, "--output-dir",
            str(tmp_path), "--micro-bsz", "2", "--lr-init", str(LR), "--warmup-steps", "0",
            "--weight-decay", "2.0", "--seed", "3", "--grad-checkpoint", "off", "--lora-r", "4",
            "--lora-alpha", "16", *extra]
    jax_run, port_run, made = {}, {}, {}

    def jax_loop(args, cfg, tc, init, step_fn, init_fn, batches, **kw):
        jax_run.update(init=init, step_fn=step_fn, init_fn=init_fn, batches=batches,
                       frozen=kw.get("frozen"))

    def port_load(path, *, device, quant=None, **kw):
        made["model"] = torch_model(params, jcfg)
        if quant:
            quantize_model(made["model"], quant)
        return made["model"], made["model"].cfg

    def port_loop(args, tc, step_fn, batches, save_fn, device, eval_fn=None):
        port_run.update(step_fn=step_fn, batches=batches)

    with mock.patch.object(jcli, "_load_base", lambda args: (dict(params), jcfg)), \
            mock.patch.object(jcli, "_run_loop", jax_loop):
        jcli.main(argv)
    with mock.patch.object(pcli, "load_rwkv_checkpoint", port_load), \
            mock.patch.object(pcli, "_run_loop", port_loop):
        pcli.main(argv + ["--platform", "cpu"])

    batches = []
    for epoch in (0, 1):
        got, want = list(port_run["batches"](epoch)), list(jax_run["batches"](epoch))
        assert len(got) == len(want) >= steps
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
        batches = batches or want

    model, rng = made["model"], np.random.default_rng(5)
    init, track = jax_run["init"], {}
    if train_type in ("lora", "pissa"):
        if train_type == "pissa":
            # the JAX command's own deflated base (its SVD is deterministic)
            deflated, _ = jax_pissa_init(dict(params), JaxLoraConfig(r=4, alpha=16.0, pissa=True))
            flat = jax_params_to_state_dict(deflated, jcfg)
        else:
            init = {k: {"A": ab["A"], "B": jnp.asarray(rng.normal(size=ab["B"].shape) * 0.05,
                                                       jnp.float32)} for k, ab in init.items()}
        for name, m in model.named_modules():
            if not isinstance(m, LoraLinear):
                continue
            if train_type == "pissa":
                w = torch.from_numpy(np.array(flat[f"{name}.weight"], np.float32))
                if quant == "none":
                    _set(m.base.weight, w)
                else:
                    m.base = quantize_linear(w, quant)
            _set(m.lora_A, init[name]["A"])
            _set(m.lora_B, init[name]["B"])
            track[f"{name}.lora_A"] = (name, "A")
            track[f"{name}.lora_B"] = (name, "B")
    elif train_type == "slot-lora":
        init = {k: {"A": ab["A"], "B": ab["B"].at[1:].set(
            jnp.asarray(rng.normal(size=ab["B"][1:].shape) * 0.05, jnp.float32))}
            for k, ab in init.items()}
        for name, m in model.named_modules():
            if isinstance(m, SlotLoraLinear):
                _set(m.A, init[name]["A"])
                _set(m.B, init[name]["B"])
                track[f"{name}.A"] = (name, "A")
                track[f"{name}.B"] = (name, "B")
    else:   # full: the same weights on both sides already
        track = {n: None for n, _ in model.named_parameters()}
    ts = jax_run["init_fn"](init)
    for batch in batches[:steps]:
        batch = _fold(batch)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if jax_run["frozen"] is not None:
            ts, jm = jax_run["step_fn"](ts, jb, jax_run["frozen"])
        else:
            ts, jm = jax_run["step_fn"](ts, jb)
        m = port_run["step_fn"](_tb(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=rtol[0])
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=rtol[1])
    named = dict(model.named_parameters())
    want_flat = jax_params_to_state_dict(ts.params, jcfg) if train_type == "full" else None
    for name, path in track.items() if compare_params else ():
        got = named[name].detach().double().numpy()
        want = np.asarray(want_flat[name] if path is None else _leaf(ts.params, path), np.float64)
        err = np.abs(got - want.reshape(got.shape)).max()
        assert err <= max(1e-5 * np.abs(want).max(), 0.5 * LR), (name, err)
    if train_type in ("lora", "pissa", "full"):
        assert _port_groups(port_run["step_fn"].optimizer, model) == _jax_groups(
            init, jcfg, model.cfg)
    return model, port_run["step_fn"]
