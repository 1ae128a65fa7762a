"""The ranks of the multi-process training CPU tests (tests/test_torch_dp.py,
tests/test_torch_pp.py).

``Pair(job, d, script=__file__)`` (tests/torch_tp_ranks.py) starts two
processes, ``python tests/torch_train_ranks.py <job> <rank> <d>``, which join
a gloo group through a file rendezvous in ``d``, run ``job`` on the inputs
the test wrote to ``d/<job>.pt`` and save their results to
``d/<job>-<rank>.pt``. They import the port only (torch), not JAX.

Jobs:
- ``dp``: ``make_mesh(dp=2)`` then ``make_mesh(tp=2)``; for each case
  (``dp_lora``, ``dp_full``, ``dp_state``, ``tp_lora``, ``tp_full``) a fresh
  fp32 model, ``make_train_step(mesh=)`` and two steps on the rank's rows
  (dp: its half of the global batch; tp: the whole batch), the first step's
  reduced gradients, the losses and norms, the trainables after the steps
  (whole: tp slices gathered) and the rank's Adam moment elements; a `full`
  step under TBPTT (chunks of 8) and under a LISA mask (block 0 kept) at
  dp=2, and on rank 0 the same on the whole batch in one process; then a
  batch of another shape on rank 1, which ``local_batch_to_global`` refuses.
- ``pp``: ``make_pp_mesh(dp=1, pp=2)``; ``pipeline_loss`` and its
  gradients on a fresh model, then one ``make_pp_train_step`` step; each
  rank returns its stage's values.
- ``dp_infonce``: ``make_mesh(dp=2)``, a LoRA model and one bi-encoder
  InfoNCE step (``contrastive_loss_fn``) on the rank's half of a triplet
  batch: the loss, the norm, the reduced gradients and the trained
  adapter.
- ``sp`` (four ranks, ``Pair(..., ranks=4)``): sequence parallelism over
  ``make_sp_mesh(4)`` and then ``make_sp_mesh(2)`` (two groups of two),
  each rank on its own time shard: ``wkv6_sequence_parallel``'s y and final
  state, ``rwkv_forward_sequence_parallel``'s logits, and the gradients of
  mean(logits^2) summed over the group; then, at sp=2, a shard one step
  shorter on the group's rank 1, which both ranks refuse by name.
"""
import sys
from pathlib import Path

import torch

from torch_tp_ranks import PAIR_TIMEOUT_S, TP


def _model(inputs, case: str):
    from rwkv_lm_ext_tpu_torch.adapters.lora import LoraConfig, apply_lora
    from rwkv_lm_ext_tpu_torch.checkpoint.convert import checkpoint_config, load_state_dict_into
    from rwkv_lm_ext_tpu_torch.models.rwkv import RWKV
    from rwkv_lm_ext_tpu_torch.train.optim import apply_trainable_mask, trainable_mask

    sd = inputs["sd"]
    model = load_state_dict_into(RWKV(checkpoint_config(sd, dtype="float32"), device="cpu"), sd)
    train_type = case.split("_")[1]
    if train_type == "lora":
        lc = LoraConfig(r=inputs["lora_r"], alpha=inputs["lora_alpha"])
        apply_lora(model, lc, inputs["adapter"])
    if train_type == "state":
        model.add_state_params()
        with torch.no_grad():
            for block, ts0 in zip(model.blocks, inputs["states"]):
                block.att.time_state.copy_(ts0)
    apply_trainable_mask(model, trainable_mask(model, "states" if train_type == "state" else
                                               train_type))
    return model


def _capture_first_grads(optimizer, out: dict) -> None:
    """Keep the gradients of the first step, as ``reduce`` leaves them."""
    reduce = optimizer.reduce

    def first():
        reduce()
        if "grads" not in out:
            out["grads"] = {n: g.clone() for n, g in optimizer.named_grads().items()}

    optimizer.reduce = first


def job_dp(rank: int, d: Path) -> dict:
    import functools

    from rwkv_lm_ext_tpu_torch.parallel.distributed import all_gather_into, local_batch_to_global
    from rwkv_lm_ext_tpu_torch.parallel.mesh import make_mesh
    from rwkv_lm_ext_tpu_torch.parallel.tp import shard_for_training, whole_state_dict
    from rwkv_lm_ext_tpu_torch.train.loop import make_train_step, sft_loss_fn

    from rwkv_lm_ext_tpu_torch.config import TrainConfig

    inputs = torch.load(d / "dp.pt")
    results = {}
    for case in ("dp_lora", "dp_full", "dp_state", "tp_lora", "tp_full"):
        mesh = make_mesh(dp=TP, tp=1) if case.startswith("dp") else make_mesh(dp=1, tp=TP)
        model = _model(inputs, case)
        shard_for_training(model, mesh)
        loss_fn = functools.partial(sft_loss_fn, remat=False,
                                    use_state_params=case == "dp_state")
        step = make_train_step(model, TrainConfig(**inputs["tc"][case.split("_")[1]]), loss_fn,
                               mesh=mesh)
        out = {"losses": [], "norms": []}
        _capture_first_grads(step.optimizer, out)
        for batch in inputs["batches"]:
            if case.startswith("dp"):
                batch = {k: v.chunk(TP)[mesh.dp_rank] for k, v in batch.items()}
            m = step(batch)
            out["losses"].append(float(m["loss"]))
            out["norms"].append(float(m["grad_norm"]))
        grads = out["grads"]
        if case.startswith("tp"):
            # the tp slices of the gradients gathered, as whole_state_dict does
            named = dict(model.named_parameters())
            for n, g in grads.items():
                axis = getattr(named[n], "tp_axis", None)
                if axis is not None:
                    parts = [torch.empty_like(g) for _ in range(TP)]
                    all_gather_into(parts, g.contiguous(), mesh.group)
                    grads[n] = torch.cat(parts, axis)
        whole = whole_state_dict(model, mesh)
        out["params"] = {n: whole[n] for n in step.optimizer.names}
        out["moments"] = step.optimizer.moment_elements()
        out["elements"] = sum(t.numel() for t in out["params"].values())
        results[case] = out
    # TBPTT (chunks of 8, the chunk counts global) and LISA's mask under
    # dp=2, against the single-process port on the whole batch (rank 0)
    mesh = make_mesh(dp=TP, tp=1)
    batch = inputs["batches"][0]
    rows = {k: v.chunk(TP)[mesh.dp_rank] for k, v in batch.items()}
    results["start"] = {n: p.detach().clone() for n, p in _model(inputs, "dp_full").named_parameters()
                        if n.startswith("blocks.0.")}
    for case, kw in (("dp_tbptt", dict(chunk_ctx=8)), ("dp_lisa", {})):
        tc = TrainConfig(**dict(inputs["tc"]["full"], **kw))
        runs = [("dp", mesh)] + ([("single", None)] if rank == 0 else [])
        for label, m in runs:
            model = _model(inputs, "dp_full")
            step = make_train_step(model, tc, mesh=m)
            names = step.optimizer.names
            mask = {n: not n.startswith("blocks.0.") for n in names} if case == "dp_lisa" else None
            out = step(rows if m is not None else batch, mask)
            results.setdefault(case, {})[label] = {
                "loss": float(out["loss"]), "norm": float(out["grad_norm"]),
                "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    # a batch of another shape on one rank is refused by name
    rows = 2 + rank
    bad = {"input_ids": torch.zeros(rows, 8, dtype=torch.int64),
           "labels": torch.zeros(rows, 8, dtype=torch.int64)}
    try:
        local_batch_to_global(bad, mesh.dp_group, mesh.dp)
        results["mismatch"] = None
    except ValueError as e:
        results["mismatch"] = str(e)
    return results


def job_pp(rank: int, d: Path) -> dict:
    from rwkv_lm_ext_tpu_torch.config import TrainConfig
    from rwkv_lm_ext_tpu_torch.parallel.pipeline import make_pp_mesh, pipeline_loss
    from rwkv_lm_ext_tpu_torch.train.loop import make_pp_train_step

    inputs = torch.load(d / "pp.pt")
    mesh = make_pp_mesh(dp=1, pp=TP)
    batch = inputs["batch"]
    model = _model(inputs, "pp_full")
    loss = pipeline_loss(model, batch["input_ids"], batch["labels"], mesh,
                         n_micro=inputs["n_micro"])
    out = {"loss": float(loss), "stage": mesh.stage,
           "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}}
    model = _model(inputs, "pp_full")
    step = make_pp_train_step(model, TrainConfig(**inputs["tc"]), mesh, n_micro=inputs["n_micro"])
    m = step(batch)
    out.update(step_loss=float(m["loss"]), step_norm=float(m["grad_norm"]),
               params={n: p.detach().clone() for n, p in model.named_parameters()})
    return out


def job_dp_infonce(rank: int, d: Path) -> dict:
    import functools

    from rwkv_lm_ext_tpu_torch.config import TrainConfig
    from rwkv_lm_ext_tpu_torch.parallel.mesh import make_mesh
    from rwkv_lm_ext_tpu_torch.train.loop import contrastive_loss_fn, make_train_step

    inputs = torch.load(d / "dp_infonce.pt")
    mesh = make_mesh(dp=TP, tp=1)
    model = _model(inputs, "dp_lora")
    loss_fn = functools.partial(contrastive_loss_fn, loss="infonce", pooling="weightedmean",
                                remat=False)
    step = make_train_step(model, TrainConfig(**inputs["tc"]), loss_fn, mesh=mesh)
    out = {}
    _capture_first_grads(step.optimizer, out)
    rows = {k: v.chunk(TP)[mesh.dp_rank] for k, v in inputs["batch"].items()}
    m = step(rows)
    out.update(loss=float(m["loss"]), norm=float(m["grad_norm"]),
               params={n: p.detach().clone() for n, p in zip(step.optimizer.names,
                                                              step.optimizer.params)})
    return out


def job_sp(rank: int, d: Path) -> dict:
    from rwkv_lm_ext_tpu_torch.parallel.distributed import all_reduce
    from rwkv_lm_ext_tpu_torch.parallel.sequence import (
        make_sp_mesh,
        rwkv_forward_sequence_parallel,
        wkv6_sequence_parallel,
    )

    inputs = torch.load(d / "sp.pt")
    results = {}
    for sp in (4, 2):
        mesh = make_sp_mesh(sp)
        out = {"rank": mesh.rank}
        wk = inputs["wkv"]
        n = wk["r"].shape[1] // sp
        shard = slice(mesh.rank * n, (mesh.rank + 1) * n)
        out["y"], out["state"] = wkv6_sequence_parallel(
            *(wk[k][:, shard] for k in "rkvw"), wk["u"], mesh=mesh, chunk_size=8)
        model = _model(inputs, "sp_full")
        tokens = inputs["tokens"]
        n = tokens.shape[1] // sp
        with torch.no_grad():
            out["logits"] = rwkv_forward_sequence_parallel(
                model, tokens[:, mesh.rank * n:(mesh.rank + 1) * n], mesh=mesh)
        tokens = inputs["grad_tokens"]
        n = tokens.shape[1] // sp
        logits = rwkv_forward_sequence_parallel(
            model, tokens[:, mesh.rank * n:(mesh.rank + 1) * n], mesh=mesh)
        ((logits.float() ** 2).sum() / (tokens.numel() * logits.shape[-1])).backward()
        out["grads"] = {name: all_reduce(p.grad.clone(), mesh.group)
                        for name, p in model.named_parameters()}
        results[sp] = out
    # shards of two lengths in one group are refused on both of its ranks
    wk = inputs["wkv"]
    T = 8 - (mesh.rank == 1)
    try:
        wkv6_sequence_parallel(*(wk[k][:, :T] for k in "rkvw"), wk["u"], mesh=mesh)
        results["mismatch"] = None
    except ValueError as e:
        results["mismatch"] = str(e)
    return results


JOBS = {"dp": job_dp, "pp": job_pp, "dp_infonce": job_dp_infonce, "sp": job_sp}


def main(job: str, rank: int, d: Path, world: int = TP) -> None:
    from rwkv_lm_ext_tpu_torch.parallel.distributed import init_distributed, shutdown

    torch.set_num_threads(1)
    init_distributed("file://" + str(d / f"{job}.rendezvous"), world, rank, platform="cpu",
                     timeout=PAIR_TIMEOUT_S)
    try:
        result = JOBS[job](rank, d)
    finally:
        shutdown()
    torch.save(result, d / f"{job}-{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]), *map(int, sys.argv[4:]))
