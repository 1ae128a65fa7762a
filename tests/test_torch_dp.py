"""Data- and tensor-parallel training of the port (train/loop.py
``make_train_step(mesh=)``, train/optim.py ``ShardedOptimizer``,
parallel/tp.py ``shard_for_training``) against the JAX package, on the CPU.

Two ranks over gloo (tests/torch_train_ranks.py job ``dp``, one spawned pair
for the module, a file rendezvous under its temporary directory; the JAX
references are computed while it runs) train a tiny fp32 RWKV-6 (2 layers,
C=128, H=2, vocab 1000: the weights of torch_stack_setup, low-rank mixers
filled so that every gradient stands well above rounding; drawn without JAX
ops, ``seeded_weights``) for two ``sft``
steps on global batches of 4 rows whose halves hold different counts of
unmasked tokens:

- dp=2 (``lora``, ``full``, ``state``) and tp=2 (``lora``, ``full``)
  against JAX ``make_train_step`` with ``place_train_state`` on a
  ``make_mesh(dp=2, tp=2)`` virtual-CPU mesh: one JAX step a train type,
  its batch sharded over dp and its heads over tp, holds both layouts.

Tolerances are tests/test_torch_train.py's: loss rtol 1e-5 (grad_norm 1e-4),
the first step's gradients within 1e-4 of the largest |JAX value|, the
parameters after the steps within 1e-5 of theirs, plus 2e-2 of the two
steps' largest move (``STEP_FLOOR``: Adam's sensitivity near eps). Each dp rank holds at most
ceil(1/dp) of the single-process Adam moment elements. The trainer CLI
(fp32 compute, ``--dtype float32``: bf16 rounds each rank's rows apart from
the whole batch's), against the single-process run at the same
``--micro-bsz``: ``sft --dp 2`` writes its ``.pth`` (within 1e-5 of max plus
the steps' floor) and logs its losses (rtol 1e-5) and grad norms (rtol 1e-4:
Adam's update hides a gradient's scale, the norm does not);
``--save-train-state`` then ``--resume-train-state`` at dp=2 continues where
the unbroken run does; ``--tp 2`` (``full``, ``lora``), ``--pp 2 --n-micro
2`` (``full``, against the single-process run without L2Wrap: JAX's
pipeline loss has none) and ``--dp 2`` under ``pissa`` and under
``slot-lora`` over an int8 base (``--quant int8``) write its files and log
its steps alike (CLI_PAIRS, each run as the command in a process of its
own); and the combinations that are not ported are refused by name.
"""
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rwkv_lm_ext_tpu.adapters import LoraConfig as JaxLoraConfig
from rwkv_lm_ext_tpu.adapters import apply_lora_unfused
from rwkv_lm_ext_tpu.checkpoint.convert import params_to_state_dict as jax_params_to_state_dict
from rwkv_lm_ext_tpu.config import TrainConfig as JaxTrainConfig
from rwkv_lm_ext_tpu.models.rwkv import rwkv_forward as jax_rwkv_forward
from rwkv_lm_ext_tpu.parallel import make_mesh as jax_make_mesh
from rwkv_lm_ext_tpu.train.losses import causal_lm_loss as jax_causal_lm_loss
from rwkv_lm_ext_tpu.train.loop import make_train_step as jax_make_train_step
from rwkv_lm_ext_tpu.train.loop import place_batch, place_train_state
from rwkv_lm_ext_tpu.train.loop import sft_loss_fn as jax_sft_loss_fn
from rwkv_lm_ext_tpu_torch.data.buckets import LengthBucketedDataset
from rwkv_lm_ext_tpu_torch.parallel.mesh import Mesh
from rwkv_lm_ext_tpu_torch.train import cli as pcli
from torch_stack_setup import seeded_weights
from torch_tp_ranks import PAIR_TIMEOUT_S, TP, Pair

torch.set_num_threads(1)  # tier-1 runs several pytest workers

REPO = Path(__file__).resolve().parent.parent
TC = dict(lr_init=1e-3, lr_final=1e-4, warmup_steps=0, total_steps=4, weight_decay=0.1,
          grad_checkpoint=False)
LORA_R, LORA_ALPHA = 4, 16.0
CASES = ("dp_lora", "dp_full", "dp_state", "tp_lora", "tp_full")


def _batches(vocab: int, B: int = 4, T: int = 16):
    """Two global batches; the first half of the rows (dp rank 0's) keeps
    fewer unmasked labels than the second."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(2):
        ids = rng.integers(3, vocab, size=(B, T)).astype(np.int32)
        labels = np.full_like(ids, -100)
        labels[:, :-1] = ids[:, 1:]
        labels[: B // 2, : T // 2 + 3] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


def _adapter(sd: dict, rng) -> dict:
    """A LoRA adapter of every att / ffn projection of ``sd`` in the JAX
    layout (A (in, r), B (r, out)): A uniform within JAX's init bound, B
    seeded too (with B = 0 every dA would be 0)."""
    adapter = {}
    for key, w in sd.items():
        if key.endswith(".weight") and (".att." in key or ".ffn." in key) and w.dim() == 2 \
                and not key.endswith("ln_x.weight"):
            n_out, n_in = w.shape
            bound = np.sqrt(3.0) * np.sqrt(2.0 / n_in)
            adapter[key[:-len(".weight")]] = {
                "A": jnp.asarray(rng.uniform(-bound, bound, size=(n_in, LORA_R)), jnp.float32),
                "B": jnp.asarray(rng.normal(size=(LORA_R, n_out)) * 0.05, jnp.float32)}
    return adapter


def _tc(kind: str) -> dict:
    """The state case trains without the clip: JAX's states mode clips (and
    takes its grad_norm) over the whole tree's gradients, the port over the
    states only (ROADMAP C, standing item 7), as tests/test_torch_train.py holds it."""
    return dict(TC, grad_clip=0.0) if kind == "state" else TC


def _jax_cases(params, jcfg, adapter, lc, states):
    """{case: (init tree, loss_fn, frozen, train_type)} of the JAX step."""
    def lora_loss(adapter_p, frozen, cfg_, batch):
        return jax_sft_loss_fn(apply_lora_unfused(frozen, adapter_p, lc), cfg_, batch,
                               remat=False, wkv_backend="reference")

    def state_loss(p, cfg_, batch):
        logits, _ = jax_rwkv_forward(p, cfg_, batch["input_ids"], use_state_params=True,
                                     wkv_backend="reference")
        return jax_causal_lm_loss(logits, batch["labels"])

    stated = jax.tree_util.tree_map(lambda x: x, params)
    for bp, ts0 in zip(stated["blocks"], states):
        bp["att"]["time_state"] = jnp.asarray(ts0)
    full_loss = functools.partial(jax_sft_loss_fn, remat=False, wkv_backend="reference")
    return {"lora": (adapter, lora_loss, params, "full"),   # the JAX CLI trains the whole adapter tree
            "full": (params, full_loss, None, "full"),
            "state": (stated, state_loss, None, "states")}


def _jax_run(kind, spec, jcfg, batches, mesh):
    init, loss_fn, frozen, train_type = spec
    init_fn, step_fn = jax_make_train_step(jcfg, JaxTrainConfig(**_tc(kind)), loss_fn=loss_fn,
                                           train_type=train_type, donate=False)
    ts = place_train_state(init_fn(init), mesh)
    losses, norms = [], []
    for b in batches:
        jb = place_batch({k: jnp.asarray(v) for k, v in b.items()}, mesh)
        ts, m = step_fn(ts, jb) if frozen is None else step_fn(ts, jb, frozen)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms, "params": ts.params}


def _jax_grads(spec, jcfg, batch):
    """The first global batch's gradients (single device: a mesh is layout)."""
    init, loss_fn, frozen, _ = spec
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if frozen is None:
        return jax.jit(jax.grad(lambda p, b: loss_fn(p, jcfg, b)))(init, jb)
    return jax.jit(jax.grad(lambda p, f, b: loss_fn(p, f, jcfg, b)))(init, frozen, jb)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_ranks")
    sd, params, jcfg = seeded_weights(3)
    lc = JaxLoraConfig(r=LORA_R, alpha=LORA_ALPHA)
    adapter = _adapter(sd, np.random.default_rng(3))
    rng = np.random.default_rng(4)
    batches = _batches(jcfg.vocab_size)
    states = [(rng.normal(size=(jcfg.n_head, jcfg.head_size, jcfg.head_size)) * 0.1)
              .astype(np.float32) for _ in range(jcfg.n_layer)]
    torch.save({"sd": sd, "tc": {kind: _tc(kind) for kind in ("lora", "full", "state")},
                "states": [torch.from_numpy(t) for t in states], "lora_r": LORA_R, "lora_alpha": LORA_ALPHA,
                "adapter": {k: {n: torch.from_numpy(np.array(t)) for n, t in ab.items()}
                            for k, ab in adapter.items()},
                "batches": [{k: torch.from_numpy(v).long() for k, v in b.items()}
                            for b in batches]}, d / "dp.pt")
    pair = Pair("dp", d, script=str(REPO / "tests" / "torch_train_ranks.py"))
    specs = _jax_cases(params, jcfg, adapter, lc, states)
    # one JAX step a train type on a dp=2 x tp=2 mesh: the batch over dp, the
    # heads over tp, the moments over dp (four of the eight virtual devices)
    mesh = jax_make_mesh(dp=TP, tp=TP, devices=jax.devices()[:TP * TP])
    want = {}
    for kind in ("lora", "full", "state"):
        want[kind] = _jax_run(kind, specs[kind], jcfg, batches, mesh)
        if kind != "state":
            want[kind]["grads"] = _jax_grads(specs[kind], jcfg, batches[0])
    return pair.results(), want, jcfg


def _jax_leaf(tree, name: str, jcfg):
    """The JAX value under the port parameter ``name`` (adapter keys
    ``<path>.lora_A`` / ``.lora_B``, or a flat state-dict key)."""
    if ".lora_" in name:
        path, ab = name.rsplit(".lora_", 1)
        return np.asarray(tree[path][ab])
    return np.asarray(jax_params_to_state_dict(tree, jcfg)[name])


def _close(got, want, rel, name, floor=0.0):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64).reshape(got.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + floor, (name, err, np.abs(want).max())


# Adam's step lr m / (sqrt(v) + eps) moves with an element's gradient by up
# to lr dg / eps where the (clipped) gradient nears eps: fp32 rounding of
# 1e-7 of a tensor's largest gradient (~1e-3 here) is then 1e-2 of a step.
# The parameters may differ by 2e-2 of the steps' largest move (lr a step)
STEP_FLOOR = 2e-2 * 2 * TC["lr_init"]


@pytest.mark.parametrize("case", CASES)
def test_steps_match_jax_on_its_mesh(runs, case):
    got, want, jcfg = runs
    w = want[case.split("_")[1]]
    flat_grads = (jax_params_to_state_dict(w["grads"], jcfg) if case.endswith("full")
                  else None)
    flat_params = jax_params_to_state_dict(w["params"], jcfg) if "lora" not in case else None
    for rank in range(TP):
        g = got[rank][case]
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-5)
        if not case.endswith("state"):      # _tc: JAX's norm is the whole tree's
            np.testing.assert_allclose(g["norms"], w["norms"], rtol=1e-4)
        for name, grad in g["grads"].items() if "grads" in w else ():
            ref = _jax_leaf(w["grads"], name, jcfg) if flat_grads is None else flat_grads[name]
            _close(grad, ref, 1e-4, f"grad {name}")
        for name, value in g["params"].items():
            ref = (_jax_leaf(w["params"], name, jcfg) if flat_params is None
                   else flat_params[name])
            _close(value, ref, 1e-5, f"param {name}", STEP_FLOOR)
    # both ranks hold the same (whole) trained values
    for name, value in got[0][case]["params"].items():
        assert torch.equal(value, got[1][case]["params"][name]), name


@pytest.mark.parametrize("case", ["dp_lora", "dp_full", "dp_state"])
def test_each_dp_rank_holds_its_share_of_the_moments(runs, case):
    got, _, _ = runs
    total = got[0][case]["elements"]
    for rank in range(TP):
        assert 0 < got[rank][case]["moments"] <= 2 * -(-total // TP), (rank, case)
    assert sum(got[r][case]["moments"] for r in range(TP)) == 2 * total


@pytest.mark.parametrize("case", ["dp_tbptt", "dp_lisa"])
def test_tbptt_and_lisa_steps_at_dp2_are_the_single_process_ones(runs, case):
    """TBPTT's running token-weighted mean over the global chunk counts and
    LISA's keep mask under the ZeRO AdamW, against the single-process port on
    the whole batch (loss rtol 1e-5, parameters as the steps' test)."""
    got, _, _ = runs
    single = got[0][case]["single"]
    for rank in range(TP):
        g = got[rank][case]["dp"]
        np.testing.assert_allclose(g["loss"], single["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["norm"], single["norm"], rtol=1e-4)
        for name, value in g["params"].items():
            _close(value, single["params"][name].numpy(), 1e-5, name, STEP_FLOOR / 2)
            if case == "dp_lisa" and name.startswith("blocks.0."):
                assert torch.equal(value, got[0]["start"][name]), name


def test_a_rank_with_another_batch_shape_is_refused_by_name(runs):
    got, _, _ = runs
    for rank in range(TP):
        assert "every rank must hold a batch of the same shape" in got[rank]["mismatch"]


# ---------------------------------------------------------------------------
# the trainer CLI
# ---------------------------------------------------------------------------

# (name, argv of the multi-process run, argv of its single-process reference
# run, the files both write): tp and pp over the whole batch on two ranks, dp's
# other train types on its halves. JAX's pipeline loss has no L2Wrap, so the
# pp run's reference trains without it (``NO_L2WRAP``)
CLI_PAIRS = [
    ("tp_full", ["--tp", "2"], "single", ["model-step2.pth"]),
    ("tp_lora", ["--tp", "2", "--train-type", "lora"], "single_lora", ["lora-step2.pth"]),
    ("pp", ["--pp", "2", "--n-micro", "2"], "single_no_l2wrap", ["model-step2.pth"]),
    ("dp_pissa", ["--dp", "2", "--train-type", "pissa"], "single_pissa",
     ["init_pissa.pth", "lora-step2.pth"]),
    ("dp_slot_int8", ["--dp", "2", "--train-type", "slot-lora", "--quant", "int8"],
     "single_slot_int8", ["lora-a-step2.pth", "lora-b-step2.pth"]),
]
SINGLE = {"single_lora": ["--train-type", "lora"], "single_no_l2wrap": [],
          "single_pissa": ["--train-type", "pissa"],
          "single_slot_int8": ["--train-type", "slot-lora", "--quant", "int8"]}
NO_L2WRAP = "single_no_l2wrap"


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """fp32 runs of the trainer CLI: a dp=2 run of 2 steps with
    --save-train-state, one single-process run of 4 steps (saves at 2 and
    4) and the dp=2 run's resume to step 4, rank 0 of each in this process;
    each of CLI_PAIRS, 2 steps, as a command of its own, and SINGLE in this
    process: {run: what rank 0 printed}."""
    from rwkv_lm_ext_tpu_torch.config import ModelConfig
    from rwkv_lm_ext_tpu_torch.models.init import init_rwkv_params
    from rwkv_lm_ext_tpu_torch.train import loop as ploop
    from torch_stack_setup import _tokenizer, sft_data

    d = tmp_path_factory.mktemp("dp_cli")
    cfg = ModelConfig(n_layer=2, n_embd=64, vocab_size=65536, head_size=16)
    gen = torch.Generator().manual_seed(4)
    sd = init_rwkv_params(cfg, generator=gen, device="cpu")
    for key in sd:
        if key.endswith(("att.output.weight", "ffn.value.weight", "ffn.receptance.weight",
                         "time_maa_w1", "time_maa_w2", "time_decay_w1", "time_decay_w2")):
            sd[key] = torch.randn(sd[key].shape, generator=gen) * (0.5 / sd[key].shape[-2] ** 0.5)
    torch.save(sd, d / "tiny.pth")
    data = {False: sft_data(d, n=16), True: sft_data(d, n=16, tasks=["a", "b"])}

    def argv(out, *extra):
        return ["sft", "--platform", "cpu", "--dtype", "float32", "--model", str(d / "tiny.pth"),
                "--train-data", data["slot-lora" in extra], "--output-dir", str(d / out),
                "--train-type", "full", "--micro-bsz", "4", "--lr-init", "1e-3",
                "--lr-schedule", "constant", "--warmup-steps", "0", "--grad-checkpoint", "off",
                "--log-every", "1", "--lora-r", "4", "--lora-alpha", "16", *extra]

    def run(out, *extra):
        """This process is rank 0 (a multi-process run starts its other
        ranks as processes of their own, ``python -m
        rwkv_lm_ext_tpu_torch.train.cli``); returns what it printed."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.ExitStack() as stack:
            # one vocabulary for the runs in this process (it takes seconds)
            stack.enter_context(mock.patch.object(pcli, "WorldTokenizer",
                                                  _tokenizer(pcli.WorldTokenizer)))
            if out == NO_L2WRAP:
                stack.enter_context(mock.patch.object(
                    ploop, "sft_loss_fn", functools.partial(ploop.sft_loss_fn, l2_wrap=False)))
            pcli.main(argv(out, *extra))
        return buf.getvalue()

    # CLI_PAIRS' multi-process runs as the command, all at once (each rank
    # spends most of its seconds importing torch and loading the vocabulary),
    # while this process makes the other runs
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {out: subprocess.Popen(
        [sys.executable, "-m", "rwkv_lm_ext_tpu_torch.train.cli",
         *argv(out, "--max-steps", "2", *extra)], cwd=REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for out, extra, _, _ in CLI_PAIRS}
    try:
        logs = {"dp": run("dp", "--dp", "2", "--max-steps", "2", "--save-train-state"),
                "single": run("single", "--max-steps", "4", "--save-every-steps", "2")}
        logs["resumed"] = run("dp", "--dp", "2", "--max-steps", "4", "--skip-steps", "2",
                              "--resume-train-state", str(d / "dp" / "train_state.pth"))
        for out, extra in SINGLE.items():
            logs[out] = run(out, "--max-steps", "2", *extra)
        for out, proc in procs.items():
            logs[out], err = proc.communicate(timeout=PAIR_TIMEOUT_S)
            assert proc.returncode == 0, (out, err[-3000:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return d, logs


def _steps(log: str) -> list:
    """[(step, loss, grad_norm)] of the lines a run logged."""
    out = []
    for line in log.splitlines():
        if line.startswith("step "):
            step, metrics = line[len("step "):].split(": ", 1)
            m = json.loads(metrics)
            out.append((int(step), m["loss"], m["grad_norm"]))
    return out


def _logs_close(got: str, want: str, steps) -> None:
    """The logged steps, losses (rtol 1e-5) and grad norms (rtol 1e-4): a
    gradient of the wrong scale shows in the norm, which Adam's update
    hides."""
    g, w = _steps(got), _steps(want)
    assert [s for s, _, _ in g] == [s for s, _, _ in w] == list(steps), (g, w)
    np.testing.assert_allclose([x[1] for x in g], [x[1] for x in w], rtol=1e-5)
    np.testing.assert_allclose([x[2] for x in g], [x[2] for x in w], rtol=1e-4)


def _pth_close(a, b, steps):
    sa, sb = (torch.load(p, weights_only=True) for p in (a, b))
    assert sorted(sa) == sorted(sb)
    for k in sa:
        _close(sb[k], sa[k].numpy(), 1e-5, k, 2e-2 * steps * 1e-3)


def test_cli_dp2_writes_the_single_process_model(cli_runs):
    d, logs = cli_runs
    assert "ranks: dp=2 tp=1 pp=1 of 2 processes" in logs["dp"]
    assert "torch.distributed backend gloo" in logs["dp"]
    assert logs["dp"].count("step 0:") == 1
    _logs_close(logs["dp"], logs["single"].split("step 2:")[0], range(2))
    _pth_close(d / "single" / "model-step2.pth", d / "dp" / "model-step2.pth", 2)
    assert sorted(p.name for p in (d / "dp").glob("train_state.pth*")) == [
        "train_state.pth", "train_state.pth.rank0", "train_state.pth.rank1"]


def test_cli_dp2_resumes_where_the_unbroken_run_is(cli_runs):
    d, logs = cli_runs
    assert "step 0:" not in logs["resumed"]
    _logs_close(logs["resumed"], "step 2:" + logs["single"].split("step 2:", 1)[1], (2, 3))
    _pth_close(d / "single" / "model-step4.pth", d / "dp" / "model-step4.pth", 4)


@pytest.mark.parametrize("name, extra, single, files", CLI_PAIRS, ids=[c[0] for c in CLI_PAIRS])
def test_cli_multiprocess_run_writes_the_single_process_files(cli_runs, name, extra, single,
                                                              files):
    """sft --tp 2 (full, lora), --pp 2 --n-micro 2 (full) and --dp 2 under
    pissa and slot-lora over an int8 base: rank 0 alone logs and writes
    the files of the single-process run on the same global batches, and
    the ranks' files are the same."""
    d, logs = cli_runs
    mesh = {"tp": "dp=1 tp=2 pp=1", "pp": "dp=1 tp=1 pp=2", "dp": "dp=2 tp=1 pp=1"}
    assert f"ranks: {mesh[name.split('_')[0]]} of 2 processes" in logs[name]
    _logs_close(logs[name], logs[single].split("step 2:")[0], range(2))
    for f in files:
        _pth_close(d / single / f, d / name / f, 2)
    assert sorted(p.name for p in (d / name).iterdir()) == sorted(files + ["train_log.txt"])


@pytest.mark.parametrize("argv, match", [
    (["bi-encoder", "--tp", "2"], "multi-process training of bi-encoder is not ported"),
    (["sft", "--tp", "2", "--pp", "2"], "--tp and --pp together"),
    (["sft", "--pp", "2", "--train-type", "full", "--accumulate-grad-batches", "2"],
     "use --n-micro"),
    (["sft", "--tp", "2", "--quant", "nf4"], "--tp with --quant"),
    (["sft", "--tp", "2", "--train-type", "states"], "--tp trains --train-type full or lora"),
])
def test_cli_refuses_what_is_not_ported_by_name(argv, match, capsys):
    with pytest.raises(SystemExit) as e:
        pcli.main([argv[0], "--model", "m.pth", "--train-data", "d.jsonl", "--output-dir", "o",
                   "--platform", "cpu", *argv[1:]])
    assert e.value.code == 2 and match in capsys.readouterr().err


def test_a_bucket_batch_that_does_not_divide_over_dp_is_refused(tmp_path):
    ds = LengthBucketedDataset()
    ds.add({"input_ids": [1, 2, 3], "labels": [2, 3, -100]}, 3)
    args = type("A", (), {"seed": 0, "micro_bsz": 3, "n_micro": 4, "shard": False})()
    args.mesh = Mesh(dp=2, tp=1, rank=0)
    with pytest.raises(SystemExit, match="does not divide over dp=2"):
        pcli._bucketed(args, ds, {64: 3}, lambda examples, n: examples)
