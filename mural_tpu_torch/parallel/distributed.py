"""Process groups and ranks of a data-parallel run (counterpart of
``mural_tpu/parallel/distributed.py``).

The JAX package shards one program over a device mesh and lets XLA
derive the collectives.  Here a data-parallel trial runs as one process
per device (a rank), joined by a ``torch.distributed`` process group:

- :func:`initialize` wraps ``init_process_group`` with an explicit
  ``tcp://`` address; the backend is NCCL on CUDA and gloo on the CPU.
  In one process it is a no-op, and there :func:`is_primary` is true.
- :func:`spawn_ranks` runs ``fn(ctx, *args)`` in one spawned process per
  device and returns each rank's result.  The caller hosts the group's
  store on a port that the OS picks (no port is reserved and released
  before the ranks bind it), and the ranks join it at
  ``127.0.0.1:<port>``.  Rank 0's ``ctx.report`` sends
  an epoch's metrics to the caller's ``report_fn`` over a pipe and
  returns its verdict (the trial runner's scheduler bridge).  A rank that
  raises, or dies, ends the others, and its exception is raised here.
- :class:`RankContext` is a rank's view of the group: its batch shard,
  the SUM all-reduce of the gradients (after ``backward``, before the
  clip), of loss sums and of validation logits (gloo offers only
  ``all_reduce`` and ``broadcast`` on CUDA tensors), and the broadcast
  of rank 0's stop flag at an epoch boundary.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import traceback
from multiprocessing.connection import wait
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from mural_tpu_torch.parallel.mesh import shard_rows

# how long a rank waits in a collective for the others
TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> None:
    """Join the process group at ``coordinator_address``
    (``host:port``) as rank ``process_id`` of ``num_processes``.  A
    no-op when a group exists already, or in one process without an
    address."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a "
                             "coordinator address")
        return
    dist.init_process_group(
        backend or default_backend(device if device is not None
                                   else "cpu"),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes or 1, rank=process_id or 0,
        timeout=TIMEOUT)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclasses.dataclass
class RankContext:
    """One rank of a data-parallel group."""
    rank: int
    world: int
    device: torch.device
    backend: str
    report: Optional[Callable] = None     # rank 0's scheduler bridge

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def shard(self, batch_size: int) -> slice:
        """This rank's rows of a global batch."""
        return shard_rows(batch_size, self.world, self.rank)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the ranks, in place."""
        dist.all_reduce(t)
        return t

    def reduce_grads(self, params) -> None:
        """SUM the gradients over the ranks in one flat all-reduce (the
        loss is a CE sum, so the global gradient is the sum).  No host
        sync: a CUDA graph captures it under NCCL."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
            flat.split([g.numel() for g in grads]), grads)])

    def gather_rows(self, local: torch.Tensor, batch_size: int
                    ) -> torch.Tensor:
        """``(n, B / world, ...)`` shards -> ``(n, B, ...)`` on every rank:
        each rank writes its columns into zeros and the ranks SUM."""
        full = local.new_zeros((local.shape[0], batch_size,
                                *local.shape[2:]))
        full[:, self.shard(batch_size)] = local
        return self.all_reduce_(full)

    def broadcast_flag(self, value: int) -> int:
        """Rank 0's ``value`` on every rank."""
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.broadcast(t, 0)
        return int(t.item())


def rank_context(device=None) -> Optional[RankContext]:
    """This process's rank on ``device`` (from the process group, whoever
    made it), or None outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return RankContext(dist.get_rank(), dist.get_world_size(),
                           torch.device(device if device is not None
                                        else "cpu"), dist.get_backend())
    return None


class _Bridge:
    """Rank 0's side of the report pipe: send the metrics, wait for the
    caller's verdict."""

    def __init__(self, conn):
        self.conn = conn

    def __call__(self, metrics) -> bool:
        self.conn.send(("report", metrics))
        return bool(self.conn.recv())


def _rank_main(conn, fn, args, rank, devices, backend, port, n_threads):
    try:
        torch.set_num_threads(n_threads)
        device = devices[rank]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        store = dist.TCPStore("127.0.0.1", port, len(devices),
                              is_master=False, timeout=TIMEOUT)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=len(devices), timeout=TIMEOUT)
        ctx = RankContext(rank, len(devices), device, backend,
                          _Bridge(conn) if rank == 0 else None)
        conn.send(("done", fn(ctx, *args)))
    except Exception as err:              # raised again by the caller
        text = traceback.format_exc()
        try:
            conn.send(("error", err, text))
        except Exception:                  # an exception that won't pickle
            conn.send(("error", RuntimeError(repr(err)), text))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        conn.close()


def spawn_ranks(fn: Callable, devices: Sequence, args: tuple = (),
                backend: Optional[str] = None,
                report_fn: Optional[Callable] = None) -> List:
    """Run ``fn(ctx, *args)`` on one spawned rank per device of
    ``devices`` (a device may repeat: two gloo ranks can share a card or
    the CPU) and return the ranks' results.  ``fn`` and ``args`` must
    pickle; the caller's torch threads are split over the ranks."""
    devices = [torch.device(d) for d in devices]
    backend = backend or default_backend(devices[0])
    ctx = mp.get_context("spawn")
    # held until the ranks are done: the group's rendezvous
    store = dist.TCPStore("127.0.0.1", 0, len(devices), is_master=True,
                          wait_for_workers=False, timeout=TIMEOUT)
    port = store.port
    n_threads = max(1, torch.get_num_threads() // len(devices))
    conns, procs = [], []
    for rank in range(len(devices)):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=_rank_main, daemon=False, args=(
            child, fn, args, rank, devices, backend, port, n_threads))
        proc.start()
        child.close()
        conns.append(parent)
        procs.append(proc)
    results: List = [None] * len(devices)
    live = dict(enumerate(conns))
    failed = True
    try:
        while live:
            for conn in wait(list(live.values())):
                rank = conns.index(conn)
                try:
                    msg = conn.recv()
                except EOFError:
                    raise RuntimeError(f"data-parallel rank {rank} exited "
                                       "without a result") from None
                if msg[0] == "report":
                    conn.send(report_fn is None
                              or report_fn(msg[1]) is not False)
                elif msg[0] == "done":
                    results[rank] = msg[1]
                    del live[rank]
                else:
                    err, text = msg[1], msg[2]
                    err.add_note(f"in data-parallel rank {rank}:\n{text}")
                    raise err
        failed = False
    finally:
        for proc in procs:
            if failed and proc.is_alive():
                proc.terminate()
            proc.join()
        for conn in conns:
            conn.close()
    return results
