"""The devices of a frame mesh, one worker process per device, and the
two collectives of the port.

Counterpart of ``facerec_tpu/parallel/mesh.py``.  A JAX mesh is one
program over n devices; here each device gets a process of its own
(the tracker is host-bound, so one Python thread driving n cards would
run their trackers one after another).  :func:`run_ranks` spawns the
processes, each pinned to its device, optionally joined in a
``torch.distributed`` process group set up through a ``FileStore`` in a
temporary directory (no port, so concurrent runs never collide).

The collectives are built on ``all_reduce`` alone, which NCCL and
gloo both offer on CUDA tensors (gloo there has only it and
``broadcast``), also when several ranks share one card.  They are
autograd functions (:func:`all_reduce`), so gradients flow back
through them: :func:`gather_rows` (rank r's rows
land in slot r of a zeroed buffer, and the sum is exact since x + 0 =
x) and :func:`shift_right` (the halo exchange ``lax.ppermute(x,
[(i, i + 1)])``: rank 0 receives zeros).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import tempfile
import traceback
from multiprocessing.connection import wait
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

FRAME_AXIS = "frames"


def mesh_devices(n: Optional[int] = None, device="cuda",
                 devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of an n-rank mesh: ``devices`` as given (a device
    may repeat: ranks then share it), else n CPU processes for
    ``device="cpu"``, else the first n visible cards (all of them when
    n is None).  Asking for more cards than are visible raises."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if n is not None and len(devs) != n:
            raise ValueError(f"{len(devs)} devices given for a mesh of {n}")
        for d in devs:
            if d.type == "cuda" and (d.index or 0) >= _cards():
                raise RuntimeError(f"{d} is not visible ({_cards()} cards)")
            if d.type not in ("cpu", "cuda"):
                raise ValueError(f"unsupported device {d}")
    elif torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * (n or 1)
    else:
        count = _cards()
        n = count if n is None else n
        if count < n:
            raise RuntimeError(f"--mesh {n} needs {n} devices; found {count}")
        devs = [torch.device("cuda", i) for i in range(n)]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def choose_backend(devices: Sequence[torch.device],
                   backend: Optional[str] = None) -> str:
    """The process group's backend: the caller's, else ``nccl`` when
    every rank has a card of its own and ``gloo`` on the CPU.  Ranks
    that share a card need ``gloo`` (NCCL refuses two ranks on one
    GPU), and asking for anything else raises."""
    cuda = [d for d in devices if d.type == "cuda"]
    shared = len(set(cuda)) < len(cuda)
    if backend is None:
        if not cuda:
            return "gloo"
        if len(cuda) != len(devices):
            raise ValueError("a mesh mixes CPU and CUDA ranks; pass its "
                             "backend")
        if shared:
            raise ValueError(
                f"ranks share a card ({[str(d) for d in devices]}): NCCL "
                f"refuses two ranks on one GPU; pass backend='gloo'")
        return "nccl"
    if backend == "nccl" and (shared or len(cuda) != len(devices)):
        raise ValueError("nccl needs one distinct card per rank; pass "
                         "backend='gloo'")
    return backend


class RankFailed(RuntimeError):
    """A worker process failed; the parent re-raises the worker's own
    exception from this one, which carries the worker's traceback."""


def run_ranks(fn: Callable, devices: Sequence, args: tuple = (),
              backend: Optional[str] = None, group: bool = True) -> list:
    """Run ``fn(rank, device, *args)`` in one spawned process per device
    and return its results in rank order.

    Each process uses one CPU thread on the CPU, or makes its card the
    current device, and turns TF32 off (``use_full_float32``).  With
    ``group`` the processes first join one process group
    (:func:`choose_backend`), left again when ``fn`` returns.  ``fn``,
    ``args`` and the results are pickled: ``fn`` must be importable by
    name, and the results must be host values (numpy, numbers), not
    tensors, which would cross through shared memory of a process that
    is exiting.

    A worker that fails fails the run: its exception is re-raised here,
    after the other workers have ended (with a group they are stopped,
    since they may wait in a collective for the one that failed)."""
    devices = [torch.device(d) for d in devices]
    world = len(devices)
    chosen = choose_backend(devices, backend) if group else None
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="facerec_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs, conns, collected = [], [], False
        try:
            for rank, dev in enumerate(devices):
                recv, send = ctx.Pipe(duplex=False)
                p = ctx.Process(target=_worker, args=(
                    fn, rank, world, str(dev), chosen, store, args, send),
                    name=f"facerec-rank{rank}")
                p.start()
                send.close()
                procs.append(p)
                conns.append(recv)
            results, failure = _collect(procs, conns, stop_on_failure=group)
            collected = True
        finally:
            for p in procs:
                # a worker that sent its result is shutting down; any
                # other is stopped (the parent itself failed)
                p.join(timeout=60 if collected else 0)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if failure is not None:
        rank, exc, tb = failure
        raise exc from RankFailed(
            f"rank {rank} on {devices[rank]} failed:\n{tb}")
    return results


def _collect(procs, conns, stop_on_failure: bool):
    """Every worker's ("ok", result) or ("error", exc, traceback), in
    rank order; the first failure (rank, exc, traceback) or None."""
    results = [None] * len(procs)
    failure = None
    pending = dict(zip(conns, range(len(procs))))
    while pending:
        for conn in wait(list(pending)):
            rank = pending.pop(conn)
            try:
                msg = conn.recv()
            except EOFError:
                procs[rank].join()
                msg = ("error", RankFailed(
                    f"rank {rank} exited with code {procs[rank].exitcode} "
                    f"and sent no result"), "")
            if msg[0] == "ok":
                results[rank] = msg[1]
            elif failure is None:
                failure = (rank, msg[1], msg[2])
                if stop_on_failure:
                    for p in procs:
                        if p.is_alive():
                            p.terminate()
    return results, failure


def _worker(fn, rank, world, device, backend, store, args, conn) -> None:
    from facerec_torch.runtime.device import use_full_float32

    try:
        use_full_float32()      # the port's float32 rule, in every rank
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        if backend is not None:
            dist.init_process_group(
                backend, store=dist.FileStore(store, world), rank=rank,
                world_size=world)
        try:
            out = fn(rank, dev, *args)
        finally:
            if backend is not None:
                dist.destroy_process_group()
        conn.send(("ok", out))
    except BaseException as e:   # reported to the parent, which raises
        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:
            e = RuntimeError(f"{type(e).__name__}: {e}")
        conn.send(("error", e, tb))
    finally:
        conn.close()


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` (sum) with its gradient: the backward sums the
    ranks' output gradients, as ``torch.distributed.nn.functional``'s
    ``all_reduce`` does (deprecated from torch 2.13 on)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank, with its
    gradient."""
    return _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's (b, ...) rows, concatenated in rank order on every
    rank, with their gradient: the backward of each rank gets the sum of
    all ranks' gradients of its rows.  Every rank passes the same b."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    zeros = torch.zeros_like(x)
    return all_reduce(torch.cat([x if i == r else zeros for i in range(n)]),
                      group)


def shift_right(x: torch.Tensor, group=None) -> torch.Tensor:
    """Rank r's ``x`` on rank r + 1, zeros on rank 0: the right shift of
    a halo, ``lax.ppermute(x, axis, [(i, i + 1)])``.  Every rank passes
    a tensor of one shape."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    zeros = torch.zeros_like(x)
    # slot j holds what rank j receives
    slots = torch.stack([x if j == r + 1 else zeros for j in range(n)])
    return all_reduce(slots, group)[r]


def average_gradients(params, group=None) -> None:
    """Sum each parameter's gradient over the ranks and divide by their
    number, in place (every rank then holds the same gradient)."""
    n = dist.get_world_size(group)
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)
            p.grad.div_(n)


def replicate(model: torch.nn.Module, group) -> None:
    """Prepare ``model`` for data-parallel steps over ``group``: its
    BatchNorms take the global batch's statistics, and every rank
    starts from rank 0's parameters and buffers."""
    from facerec_torch.models.layers import set_batch_norm_group

    set_batch_norm_group(model, group)
    broadcast_tensors(list(model.parameters()) + list(model.buffers()),
                      group)


def broadcast_tensors(tensors, group=None) -> None:
    """Rank 0's values into every rank's tensors, in place."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


def same_on_all_ranks(tensors, group=None) -> bool:
    """True on every rank when each tensor equals rank 0's bit for bit
    (compared on the first tensor's device)."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    dev = tensors[0].device
    same = True
    for t in tensors:
        mine = t.detach().to(dev, copy=True)
        ref = mine.clone()
        dist.broadcast(ref, src=src, group=group)
        same = same and torch.equal(ref, mine)
    flag = torch.tensor([float(same)], device=dev)
    dist.all_reduce(flag, group=group)
    return int(flag.item()) == dist.get_world_size(group)


def replicas_identical(model: torch.nn.Module, optimizer, group=None) -> bool:
    """True on every rank when the parameters, buffers (BatchNorm's
    running statistics) and optimizer state equal rank 0's bit for
    bit."""
    tensors = list(model.parameters()) + list(model.buffers())
    for state in optimizer.state.values():
        tensors += [v for _, v in sorted(state.items())
                    if torch.is_tensor(v)]
    return same_on_all_ranks(tensors, group)
