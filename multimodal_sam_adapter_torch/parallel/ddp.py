"""Data parallelism over processes: the counterpart of
multimodal_sam_adapter_tpu/parallel/mesh.py.

The JAX package runs one sharded program over a mesh: the batch split on
its 'data' axis, the state replicated, the gradient all-reduce and the
global BatchNorm statistics inserted by XLA, the evaluation's histograms
gathered with `gather_results`. The port runs one process a rank, as the
reference trains (DistributedDataParallel over NCCL with SyncBN):

- `init_distributed(backend)` joins the process group that torchrun's
  environment describes (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
  `LOCAL_WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`); without it, one
  process and no group;
- `rank_device()` is the rank's card, `cuda:LOCAL_RANK % device_count`;
- `wrap_model` wraps the segmentor in DistributedDataParallel when there
  is more than one rank (the gradient all-reduce), over every rank or over
  a group of them (a tensor-parallel mesh's data group, parallel/tp.py);
- `all_reduce_sum` sums an array or a tensor over the ranks, or a group
  of them (the evaluator's histograms, the logged loss);
- `average_partial_grads` averages an accumulation's partial gradients
  over the ranks before its state is saved;
- nn/layers.py's `BatchNorm2d` sums its statistics over the ranks;
- `launch_ranks` runs a command as N local ranks with torchrun's
  environment (the tensor-parallel dryrun, graft_entry.py).

The backend is the caller's choice and nothing changes it: `nccl` where
each rank has a card of its own, `gloo` for ranks on the CPU or ranks that
share a card (NCCL refuses two ranks on one device). NCCL asked for
without a card, or for ranks that share one, raises.
"""
from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(backend: str = "nccl") -> Tuple[int, int]:
    """Join the process group of torchrun's environment over `backend`
    and return (rank, world). Without `WORLD_SIZE` in the environment
    (a plain `python` run) nothing happens: (0, 1). Under NCCL the rank's
    card becomes the current device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if _initialized():
        return rank_world()
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA card on every "
                               "rank (use gloo for ranks on the CPU)")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(
                f"the nccl backend refuses two ranks on one device: "
                f"{local_world} ranks on this host share {cards} card(s) "
                f"(use gloo, or one rank a card)")
        torch.cuda.set_device(rank_device())
    dist.init_process_group(backend, rank=rank, world_size=world)
    return rank, world


def close_distributed() -> None:
    """Leave the process group, if there is one."""
    if _initialized():
        dist.destroy_process_group()


def rank_world() -> Tuple[int, int]:
    """(rank, world) of the process group; (0, 1) without one."""
    if not _initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main() -> bool:
    return rank_world()[0] == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if rank_world()[1] > 1:
        dist.barrier()


def rank_device() -> torch.device:
    """The rank's card: cuda:LOCAL_RANK % device_count. Raises without a
    card: a rank never falls back to the CPU on its own."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card for this rank (pass --device cpu "
                           "for the plain PyTorch path)")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _size(group: Optional[dist.ProcessGroup]) -> int:
    return rank_world()[1] if group is None else dist.get_world_size(group)


def wrap_model(model: torch.nn.Module,
               group: Optional[dist.ProcessGroup] = None) -> torch.nn.Module:
    """`model` in DistributedDataParallel over `group` (None: every rank)
    when it has more than one rank, else `model` itself. Buffers are not
    broadcast: the port's BatchNorm2d keeps its running statistics equal
    on every rank."""
    if _size(group) == 1:
        return model
    device = next(model.parameters()).device
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False, process_group=group)


def _wire_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(x: Union[np.ndarray, torch.Tensor],
                   group: Optional[dist.ProcessGroup] = None
                   ) -> Union[np.ndarray, torch.Tensor]:
    """The sum of `x` over the ranks of `group` (None: every rank; a copy,
    `x` itself is left as it is), as JAX's `gather_results` followed by
    `.sum(0)`. A numpy array goes over the wire in its own dtype (float64
    for the evaluator's histograms: NCCL and gloo both reduce it) on the
    backend's device and comes back as numpy; a tensor stays where it is.
    Without a process group: a copy."""
    if isinstance(x, np.ndarray):
        if not _initialized():
            return x.copy()
        t = torch.from_numpy(np.ascontiguousarray(x)).to(_wire_device(),
                                                         copy=True)
        dist.all_reduce(t, group=group)
        return t.cpu().numpy()
    t = x.detach().clone()
    if _initialized():
        dist.all_reduce(t, group=group)
    return t


def average_partial_grads(optimizer,
                          group: Optional[dist.ProcessGroup] = None) -> None:
    """Partway through an accumulation on data-parallel ranks, replace
    each rank's summed gradients (DDP averages them only at the
    accumulation's last micro-step) by their mean over the ranks of
    `group` (None: every rank; a tensor-parallel mesh's data group, whose
    ranks hold the same shares): a collective, which every rank calls
    before the optimizer's state is saved. The update at the
    accumulation's end averages them to the same value (the mean is
    linear), so the run that saved and the run that resumes go on from
    the same gradients. A no-op on one rank and at an accumulation's
    boundary."""
    world = _size(group)
    if world == 1 or optimizer.mini_step == 0:
        return
    with torch.no_grad():
        for g in optimizer.param_groups:
            for p in g["params"]:
                if p.grad is not None:
                    p.grad.copy_(all_reduce_sum(p.grad, group) / world)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on (now)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> Dict[str, str]:
    """torchrun's environment for local rank `rank` of `world`."""
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                MASTER_PORT=str(port))


def launch_ranks(argv: Sequence[str], world: int, timeout: float,
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None) -> List[Tuple[int, str]]:
    """Run `argv` as `world` processes on this host, each with torchrun's
    environment on top of `env` (default: this process's), and wait for
    them. Returns each rank's (exit code, output: stdout and stderr).
    Ranks still running after `timeout` seconds are killed (exit code None
    then); no process outlives the call.

    The ranks meet at a TCPStore that this call hosts, as torchrun's agent
    does (`TORCHELASTIC_USE_AGENT_STORE`: every rank a client): its port is
    bound before any rank starts and held until the last one ends, so no
    other process can take it or join the group. (A port probed free and
    left for rank 0 to bind could be taken in between, or handed to
    another launch's ranks, whose group would then take in strangers.)"""
    store = dist.TCPStore("localhost", 0, world, is_master=True,
                          wait_for_workers=False)
    rendezvous = dict(TORCHELASTIC_USE_AGENT_STORE=str(True),
                      TORCHELASTIC_RESTART_COUNT="0")
    procs = [subprocess.Popen(list(argv), cwd=cwd,
                              env=dict(env or os.environ,
                                       **rank_env(r, world, store.port),
                                       **rendezvous),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    out, t0 = [], time.monotonic()
    try:
        for p in procs:
            try:
                log, _ = p.communicate(
                    timeout=max(1.0, timeout - (time.monotonic() - t0)))
                out.append((p.returncode, log))
            except subprocess.TimeoutExpired:
                p.kill()
                out.append((None, p.communicate()[0]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        del store
    return out
