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

``make_hybrid_mesh`` and ``local_batch_to_global`` belong to multi-process
training, which is not ported yet (ROADMAP A.12, training part).
"""
from __future__ import annotations

import datetime
import json
import os
from typing import Optional

import torch
import torch.distributed as dist

# seconds any collective of the group waits for its peers
COLLECTIVE_TIMEOUT_S = 300.0

_control_group = None     # gloo group for broadcast_obj under NCCL
_backend: Optional[str] = None


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
