"""Multi-process execution on torch.distributed.

Counterpart of rwkv_lm_ext_tpu/parallel/distributed.py: ``init_distributed``
(:35-60), ``process_count`` / ``process_index`` / ``is_main_process``
(:63-75) and ``broadcast_obj`` (:113-135). The JAX package runs one
controller a process over a global device set (``jax.distributed``); here
each process is one rank of a ``torch.distributed`` process group, so a
tensor-parallel server of ``tp`` ranks is ``tp`` processes.

``init_distributed`` resolves its settings as the JAX function does:
explicit arguments, then ``RWKV_COORDINATOR`` / ``RWKV_NUM_PROCESSES`` /
``RWKV_PROCESS_ID``, then nothing (a single process, no group). The
coordinator is ``host:port`` (a TCP rendezvous that rank 0 serves) or a
``file://`` path on a file system that every rank sees. The backend follows
one rule, printed at start-up (``backend_rule``): NCCL where every rank has a
card of its own (a CUDA run with at least as many cards as ranks; rank r takes
card r of its host), gloo where ranks share a card (all of them take card 0) or on the
CPU. Gloo's collectives on card tensors are staged through host memory
(``host_staged``): they cannot be captured into a CUDA graph, which is why a
gloo engine runs eager decode blocks (infer/engine.py). Every collective of
the group gives up after ``COLLECTIVE_TIMEOUT_S``, so a rank whose peer is
gone exits instead of hanging.

``broadcast_obj`` sends a JSON value from process 0: its length, then its
bytes, so it has no fixed cap. The JAX function pads every message to
``_BCAST_MAX`` = 64 KB and raises above it inside the serving loop (ADVICE
r5); the port's lockstep server bounds each request instead, where it is
submitted, and refuses only that request (infer/continuous.py
``LockstepBatcherDriver``). Under NCCL the control messages go through a gloo
group of their own, on host tensors.

Training's half (JAX :78-110, :138-155): ``make_hybrid_mesh`` builds the
(dp, tp) mesh over every process with JAX's guard that a tp group stays on
one host (the ranks of a host are consecutive: process-major order), and
``local_batch_to_global`` states the global batch: each rank's rows are its
own slice of it, the global batch is the ranks' rows in rank order, and every
rank must hold the same shape (it raises by name otherwise). The collectives
below (``all_reduce``, ``broadcast``, ``all_gather_into``, ``isend`` /
``recv``) stage card tensors through host memory under gloo and count
themselves in ``STATS`` (calls and bytes), which the trainers read as
"collectives a step".

Two of them are differentiable, for the losses and the scans whose result
on one rank depends on the others' rows: ``all_gather_autograd`` (JAX's
``lax.all_gather`` and its transpose: forward the ranks' tensors stacked
along a new leading axis, backward each rank's slice of the gradient summed
over the ranks) and ``ppermute_next`` (JAX's ``lax.ppermute`` with the pairs
(i, i + 1 mod n): forward rank i's tensor to rank i + 1, backward the
gradient back to rank i). The contrastive trainers gather the pooled
embeddings of the global batch through the first (train/loop.py), sequence
parallelism the shards' WKV states through the first and the token-shift
boundary rows through the second (parallel/sequence.py). Both run on every
rank of ``group`` in the same order, forward and backward: a rank whose loss
does not read the result must still keep it in its graph (a zero-weighted
use), so that its backward joins the others'. They go through the counted
helpers above, so ``STATS`` counts them too; their backward sums in fp32.
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import sys
import threading
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

# seconds any collective of the group waits for its peers
COLLECTIVE_TIMEOUT_S = 300.0

_control_group = None     # gloo group for broadcast_obj under NCCL
_backend: Optional[str] = None

# collectives issued by this process (the helpers below): calls and bytes
STATS = {"calls": 0, "bytes": 0}


def init_method(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; ``tcp://`` and ``file://``
    addresses as they are."""
    if coordinator.startswith(("tcp://", "file://")):
        return coordinator
    return f"tcp://{coordinator}"


def backend_rule(platform: str, world: int) -> tuple:
    """(backend, reason): NCCL where each of the ``world`` ranks has a card
    of its own, gloo where they share one, or on the CPU."""
    if platform == "cuda":
        cards = torch.cuda.device_count()
        if cards >= world:
            return "nccl", f"{world} ranks, {cards} cards: a card each"
        return "gloo", (f"{world} ranks share {cards} card(s): NCCL takes one rank a card; "
                        "collectives staged through host memory")
    return "gloo", "CPU tensors"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    platform: str = "cpu",
    timeout: float = COLLECTIVE_TIMEOUT_S,
) -> bool:
    """Join the process group if this is a multi-process run; returns True
    when one is active. Resolution order: explicit arguments, then the
    RWKV_COORDINATOR / RWKV_NUM_PROCESSES / RWKV_PROCESS_ID environment,
    then a no-op (False). ``platform`` ("cuda" or "cpu") feeds the backend
    rule (module docstring), which is printed."""
    global _backend, _control_group
    coordinator = coordinator or os.environ.get("RWKV_COORDINATOR")
    if num_processes is None and os.environ.get("RWKV_NUM_PROCESSES"):
        num_processes = int(os.environ["RWKV_NUM_PROCESSES"])
    if process_id is None and os.environ.get("RWKV_PROCESS_ID"):
        process_id = int(os.environ["RWKV_PROCESS_ID"])
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator, the number of processes and this "
            f"process's id; got coordinator={coordinator!r}, num_processes={num_processes!r}, "
            f"process_id={process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
    backend, why = backend_rule(platform, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    wait = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method(coordinator),
                            world_size=num_processes, rank=process_id, timeout=wait)
    _backend = backend
    _control_group = dist.new_group(backend="gloo", timeout=wait) if backend == "nccl" else None
    print(f"process {process_id} of {num_processes}: torch.distributed backend {backend} ({why})",
          flush=True)
    return True


def backend() -> Optional[str]:
    """The group's backend ("nccl" or "gloo"), None without a group."""
    return _backend if dist.is_initialized() else None


def rank_device(platform: str) -> torch.device:
    """This rank's device: the CPU, its own card under NCCL, card 0 where
    the ranks share cards."""
    if platform != "cuda":
        return torch.device(platform)
    if backend() == "nccl":
        return torch.device("cuda", process_index() % torch.cuda.device_count())
    return torch.device("cuda", 0)


def collective_device() -> torch.device:
    """Where a small tensor made for a collective lives: this rank's card
    under NCCL, else the CPU."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Gate for host-side side effects (logs, the HTTP port, files): rank 0."""
    return process_index() == 0


def host_staged(t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` goes through host memory: a card tensor
    under gloo."""
    return t.device.type == "cuda" and backend() == "gloo"


def _count(t: torch.Tensor) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over ``group`` (None: every process), in place; returns
    it. A card tensor under gloo goes through host memory."""
    _count(t)
    if host_staged(t):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of global rank ``src`` into ``t`` of every rank of ``group``."""
    _count(t)
    if host_staged(t):
        h = t.cpu()
        dist.broadcast(h, src=src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather_into(outs: List[torch.Tensor], t: torch.Tensor, group=None) -> None:
    """Every rank's ``t`` into ``outs`` (one tensor a rank of ``group``, in
    its rank order); ``outs`` may be views of one buffer."""
    _count(t)
    if host_staged(t):
        parts = [torch.empty(o.shape, dtype=o.dtype) for o in outs]
        dist.all_gather(parts, t.cpu(), group=group)
        for o, h in zip(outs, parts):
            o.copy_(h)
    else:
        dist.all_gather(outs, t.contiguous(), group=group)


class _Sent:
    """An ``isend`` in flight and the buffer it reads (kept alive until
    ``wait``)."""

    def __init__(self, work, buf: torch.Tensor):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()
        self.buf = None


def isend(t: torch.Tensor, dst: int) -> _Sent:
    """Start sending ``t`` to global rank ``dst``; ``wait()`` the handle
    before ``t`` changes."""
    _count(t)
    src = t.cpu() if host_staged(t) else t.contiguous()
    return _Sent(dist.isend(src, dst), src)


def recv(t: torch.Tensor, src: int) -> torch.Tensor:
    """Receive into ``t`` from global rank ``src``; returns ``t``."""
    _count(t)
    if host_staged(t):
        h = torch.empty(t.shape, dtype=t.dtype)
        dist.recv(h, src)
        t.copy_(h)
    else:
        dist.recv(t, src)
    return t


def group_size(group=None) -> int:
    """Ranks of ``group`` (None: every process)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    """This process's rank within ``group`` (None: every process)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def _gathered(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked along a new leading axis, in rank order."""
    out = torch.empty((group_size(group),) + tuple(t.shape), dtype=t.dtype, device=t.device)
    all_gather_into(list(out.unbind(0)), t.contiguous(), group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _gathered(t, group)

    @staticmethod
    def backward(ctx, g):
        summed = all_reduce(g.float().contiguous().clone(), ctx.group)
        return summed[group_rank(ctx.group)].to(g.dtype), None


class _PermuteNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        n, r = group_size(group), group_rank(group)
        return _gathered(t, group)[(r - 1) % n].clone()

    @staticmethod
    def backward(ctx, g):
        n, r = group_size(ctx.group), group_rank(ctx.group)
        return _gathered(g.contiguous(), ctx.group)[(r + 1) % n].clone(), None


def all_gather_autograd(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``t`` (each of the same shape) stacked along a new
    leading axis in rank order, as ``lax.all_gather``; differentiable: each
    rank's gradient is its slice of the gradient summed over the ranks (the
    transpose of the gather, a reduce-scatter, here an all-reduce of the
    whole gradient of which a rank keeps its slice). Alone in a process it
    is ``t[None]``."""
    if group_size(group) == 1:
        return t[None]
    return _AllGather.apply(t, group)


def ppermute_next(t: torch.Tensor, group=None) -> torch.Tensor:
    """Rank i's ``t`` on rank (i + 1) mod n, as ``lax.ppermute`` with the
    pairs (i, i + 1 mod n); differentiable: the gradient goes back the
    reverse way. The boundary rows it carries are a few KB, so it is one
    all-gather of which each rank keeps its predecessor's tensor: no send
    has to be paired with a receive. Alone in a process it is ``t``."""
    if group_size(group) == 1:
        return t
    return _PermuteNext.apply(t, group)


def new_groups(blocks: List[List[int]]):
    """This rank's group among ``blocks`` (lists of global ranks that
    partition every process). Every rank creates every group, in the same
    order (``torch.distributed.new_group`` is a collective of the whole
    world); one block of every process is the world group itself."""
    if len(blocks) == 1:
        return dist.group.WORLD
    mine = None
    wait = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    for ranks in blocks:
        g = dist.new_group(ranks=list(ranks), timeout=wait)
        if process_index() in ranks:
            mine = g
    return mine


def host_names() -> List[str]:
    """Every process's host name, in rank order."""
    names = [None] * process_count()
    dist.all_gather_object(names, socket.gethostname(), group=_control_group)
    return names


def check_on_one_host(blocks: List[List[int]], what: str) -> None:
    """Raise, as JAX's meshes do, where a group of ``what`` (tp, pp) spans
    hosts: its collectives would cross the slow links every step."""
    if process_count() == 1:
        return
    hosts = host_names()
    for i, ranks in enumerate(blocks):
        seen = sorted({hosts[r] for r in ranks})
        if len(seen) > 1:
            raise RuntimeError(
                f"{what} group {i} (ranks {list(ranks)}) spans hosts {seen}: start the ranks of "
                f"one host consecutively (process-major order) so that each {what} group stays "
                "on one host")


def make_hybrid_mesh(dp: Optional[int] = None, tp: int = 1):
    """The (dp, tp) training mesh over every process (JAX :78-110): dp
    spans processes outermost, rank = d * tp + t, so a tp group is ``tp``
    consecutive ranks and must stay on one host (``check_on_one_host``).
    ``dp`` defaults to the processes over tp."""
    from rwkv_lm_ext_tpu_torch.parallel.mesh import make_mesh

    world = process_count()
    dp = dp or world // tp
    if dp * tp != world:
        raise ValueError(f"dp*tp={dp * tp} must be the number of processes ({world}): the port "
                         "runs one rank a process")
    check_on_one_host([list(range(d * tp, (d + 1) * tp)) for d in range(dp)], "tp")
    return make_mesh(dp=dp, tp=tp)


def local_batch_to_global(batch: Dict[str, torch.Tensor], group, dp: int, *,
                          counts: Optional[torch.Tensor] = None, row_axis: int = 0):
    """The port's statement of the global batch (JAX :138-155): this
    rank's ``batch`` holds its own rows of it, the global batch is the dp
    ranks' rows in rank order. Checks that every rank of ``group`` (the dp
    group) holds leaves of the same shapes, and raises by name otherwise;
    sums ``counts`` (an int64 vector of per-rank token counts, or None) over
    the ranks in the same collective. Returns (global rows along
    ``row_axis``, the summed counts)."""
    keys = sorted(batch)
    rows = batch[keys[0]].shape[row_axis]
    if dp == 1:
        return rows, counts
    shape = []
    for k in keys:
        dims = list(batch[k].shape)[:4]
        shape += dims + [-1] * (4 - len(dims))
    extra = (torch.zeros(0, dtype=torch.int64) if counts is None
             else counts.reshape(-1).to("cpu", torch.int64))
    mine = torch.cat([torch.tensor(shape, dtype=torch.int64), extra]).to(collective_device())
    parts = [torch.empty_like(mine) for _ in range(dp)]
    all_gather_into(parts, mine, group)
    n = len(shape)
    for r, part in enumerate(parts):
        if not torch.equal(part[:n].cpu(), mine[:n].cpu()):
            theirs = part[:n].cpu().reshape(len(keys), 4).tolist()
            raise ValueError(
                f"every rank must hold a batch of the same shape: dp rank {r} holds "
                f"{dict(zip(keys, ([d for d in s if d >= 0] for s in theirs)))}, this rank "
                f"{ {k: list(batch[k].shape) for k in keys} }")
    total = None
    if counts is not None:
        total = torch.stack([p[n:] for p in parts]).sum(0).reshape(counts.shape).to(counts.device)
    return rows * dp, total


def broadcast_obj(obj=None):
    """A JSON-serialisable value from process 0 to every process (each HTTP
    request or batcher tick of the lockstep server). Every process calls
    it; the others pass nothing and get process 0's value. The length goes
    first, then the bytes: there is no fixed cap."""
    if process_count() == 1:
        return obj
    group = _control_group
    if is_main_process():
        data = json.dumps(obj).encode()
        n = torch.tensor([len(data)], dtype=torch.int64)
    else:
        n = torch.zeros(1, dtype=torch.int64)
    dist.broadcast(n, src=0, group=group)
    if is_main_process():
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    else:
        buf = torch.empty(int(n), dtype=torch.uint8)
    dist.broadcast(buf, src=0, group=group)
    return json.loads(bytes(buf.numpy()))


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    global _backend, _control_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _backend = _control_group = None


def leave_within(seconds: float) -> None:
    """``shutdown``, or exit the process at once (code 1) if leaving takes
    more than ``seconds``: no rank outlives its command."""
    leaving = threading.Thread(target=shutdown, daemon=True)
    leaving.start()
    leaving.join(seconds)
    if leaving.is_alive():
        print(f"rank could not leave its process group in {seconds:g} s; exiting",
              file=sys.stderr, flush=True)
        os._exit(1)
