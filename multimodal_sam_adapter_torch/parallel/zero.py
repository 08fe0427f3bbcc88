"""ZeRO-1: the optimizer's state sharded over the data-parallel ranks, the
counterpart of multimodal_sam_adapter_tpu/parallel/zero.py.

The JAX package places every optimizer-state tensor sharded over the
mesh's 'data' axis on its largest divisible axis and leaves the update
math as it is; XLA inserts the reduce-scatter of the gradients and the
all-gather of the updated parameters. The port makes the same cut of
memory by placing each tensor's whole state on one rank:

- every parameter tensor has one owning rank (`owners`): the tensors in
  decreasing size, ties in parameter order, each to the rank that holds
  the fewest elements so far, ties to the lowest rank. Every rank computes
  the same split from the parameter order alone;
- the gradient is reduced as DistributedDataParallel reduces it, one
  all-reduce an update, and the accumulated gradients stay in every
  rank's `.grad` as DDP keeps them (JAX shards MultiSteps' sum with the
  rest of its opt_state);
- each rank updates only the tensors it owns, with LayerDecayAdamW's own
  per-tensor code, and keeps only their state: the bf16 first moment and
  the float32 second moment, or the factored moments;
- the updated tensors then go out from their owners by broadcast, in
  buckets of at most BUCKET_BYTES.

So the update is bit-equal to the unsharded optimizer's on the same
gradients, where JAX's sharded step is within round-off of its replicated
one (tests/test_zero.py).

Checkpoints: `consolidate_state_dict()`, which every rank calls, gathers
the state on one rank, whose `state_dict()` is then exactly
LayerDecayAdamW's format (engine/checkpoint.py files do not change);
`load_state_dict` takes that format, from either optimizer, and keeps the
entries the rank owns. Without a process group there is one rank, which
owns everything.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..engine.optim import LayerDecayAdamW
from .ddp import rank_world

BUCKET_BYTES = 1 << 28


def owners(sizes: Sequence[int], world: int) -> List[int]:
    """The owning rank of each of the tensors of `sizes` elements, in
    their order: greedy by size (largest first, ties in order), each to
    the rank with the fewest elements so far (ties: the lowest rank)."""
    load = [0] * world
    out = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: -sizes[i]):
        r = min(range(world), key=load.__getitem__)
        out[i] = r
        load[r] += sizes[i]
    return out


def _buckets(tensors: List[torch.Tensor], max_bytes: int
             ) -> Iterator[List[torch.Tensor]]:
    """Runs of `tensors` of one dtype and device, each of at most
    `max_bytes` unless a single tensor is larger."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (size + nbytes > max_bytes or t.dtype != run[0].dtype
                    or t.device != run[0].device):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


def _broadcast(src: int, shapes: List[torch.Size], dtype: torch.dtype,
               device: torch.device, tensors: Optional[List[torch.Tensor]]
               ) -> List[torch.Tensor]:
    """Tensors of `shapes` and one dtype from rank `src`, which passes
    them as `tensors` (None elsewhere), to every rank as one flat buffer;
    returns the received values as views of it."""
    sizes = [int(np.prod(s)) for s in shapes]
    if tensors is not None:
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    else:
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    dist.broadcast(flat, src=src)
    return [v.view(s) for v, s in zip(flat.split(sizes), shapes)]


class ZeroAdamW(LayerDecayAdamW):
    """LayerDecayAdamW with its state sharded over the ranks of the
    process group (see the module's docstring). Build it with
    `shard_optimizer`."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if any(getattr(p, "tp_split", None) is not None
               for p in self._params()):
            raise ValueError("ZeRO over every rank would mix the model "
                             "ranks' shares of a tensor-parallel model "
                             "(parallel/tp.py): not ported")
        self.rank, self.world = rank_world()
        params = self._params()
        self.owner = owners([p.numel() for p in params], self.world)
        self._owner_of = {id(p): r for p, r in zip(params, self.owner)}
        self._consolidated = None

    def owns(self, p: torch.Tensor) -> bool:
        return self._owner_of[id(p)] == self.rank

    def _update(self) -> None:
        super()._update()
        if self.world == 1:
            return
        params = self._params()
        for r in range(self.world):
            theirs = [p for p, o in zip(params, self.owner) if o == r]
            for bucket in _buckets(theirs, BUCKET_BYTES):
                mine = r == self.rank
                got = _broadcast(r, [p.shape for p in bucket],
                                 bucket[0].dtype, bucket[0].device,
                                 bucket if mine else None)
                if not mine:
                    for p, v in zip(bucket, got):
                        p.copy_(v)

    def consolidate_state_dict(self, to: int = 0) -> None:
        """Gather the whole state on rank `to` (a collective: every rank
        calls it), whose `state_dict()` then returns it, the entries of
        other ranks on the CPU."""
        if self.world == 1:
            return
        local = super().state_dict()
        device = self._params()[0].device
        state = {}
        for r in range(self.world):
            meta = [[(i, k, tuple(v.shape), v.dtype)
                     for i, st in sorted(local["state"].items())
                     for k, v in st.items()] if r == self.rank else None]
            dist.broadcast_object_list(meta, src=r)
            for dtype in sorted({e[3] for e in meta[0]}, key=str):
                entries = [e for e in meta[0] if e[3] == dtype]
                ours = ([local["state"][i][k] for i, k, _, _ in entries]
                        if r == self.rank else None)
                got = _broadcast(r, [e[2] for e in entries], dtype, device,
                                 ours)
                if self.rank == to:
                    for (i, k, _, _), v, o in zip(entries, got,
                                                  ours or got):
                        state.setdefault(i, {})[k] = (o if r == to
                                                      else v.cpu())
        self._consolidated = None
        if self.rank == to:
            self._consolidated = (self._counts(),
                                  dict(local, state=dict(sorted(
                                      state.items()))))

    def _counts(self):
        return self.mini_step, self.updates

    def state_dict(self) -> dict:
        """The whole state in LayerDecayAdamW's format: on one rank, the
        state of every rank as `consolidate_state_dict()` gathered it,
        which must have been called since the last `step`; raises on the
        other ranks. With one rank, its own state."""
        if self.world == 1:
            return super().state_dict()
        if self._consolidated is None or (
                self._consolidated[0] != self._counts()):
            raise RuntimeError(
                "ZeroAdamW.state_dict: call consolidate_state_dict() on "
                "every rank after the last step; the state is then on the "
                "rank it was gathered to")
        return self._consolidated[1]

    def load_state_dict(self, state_dict: dict) -> None:
        """LayerDecayAdamW's format (a ZeRO or an unsharded optimizer's);
        the rank keeps the state of the tensors it owns."""
        params = self._params()
        mine = {i: st for i, st in state_dict["state"].items()
                if self.owns(params[i])}
        super().load_state_dict(dict(state_dict, state=mine))
        self._consolidated = None

    def state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds."""
        return sum(v.numel() * v.element_size() for st in self.state.values()
                   for v in st.values() if torch.is_tensor(v))


def shard_optimizer(optimizer: LayerDecayAdamW) -> ZeroAdamW:
    """A ZeroAdamW over the same parameter groups, schedule and settings as
    `optimizer`, carrying its state (the rank's share of it) and counts."""
    zero = ZeroAdamW([dict(g) for g in optimizer.param_groups],
                     optimizer.schedule, optimizer.betas, optimizer.eps,
                     optimizer.grad_accum_steps, optimizer.factored)
    zero.load_state_dict(optimizer.state_dict())
    return zero
