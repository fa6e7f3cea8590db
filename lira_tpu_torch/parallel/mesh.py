"""The rank group the sharded modules run on (port of lira_tpu/parallel/mesh.py).

lira_tpu drives a 1-D `data` mesh from one controller.  Here every rank is
a process of its own running the same program: `make_mesh` joins one rank
to a `torch.distributed` group and returns a `Mesh` record (its rank, the
group's size, its device and the process group), and `launch` spawns the
ranks of a group, runs one function on every rank and returns rank 0's
result, so `--n_shards N` on a CLI is still one command.

Backends: `nccl` (the default) takes one card per rank.  Ranks that share
a card, and ranks on the CPU, take `gloo`, which runs its algorithms on
host memory: `host_collective` stages a card tensor through the host for
it.  A rank's device is explicit — `cuda:(rank % cards)` or `cpu` — and a
rank never carries on on the CPU when the card is missing.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import resolve_device


@dataclass
class Mesh:
    rank: int
    size: int
    device: torch.device
    group: object  # the torch.distributed process group of these ranks
    backend: str

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's `t` (same shape on every rank), in rank order, on
        this rank's device.  The list form: gloo has no
        all_gather_into_tensor."""
        src = host_collective(self, t)
        out = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(out, src, group=self.group)
        return [o.to(t.device) for o in out]

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t`, on this rank's device (a new tensor)."""
        buf = host_collective(self, t).clone()
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)


def host_collective(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective takes: `t` itself under nccl; under gloo a
    host copy, since gloo's algorithms run on host memory (it stages some
    card tensors itself and refuses others).  Only the collective's operand
    moves: the computation stays on the rank's device."""
    t = t.contiguous()
    return t.cpu() if mesh.backend == "gloo" else t


def _check_backend(size: int, backend: str, device) -> None:
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: expected 'nccl' or 'gloo'")
    if backend != "nccl":
        return
    if resolve_device(device).type != "cuda":
        raise ValueError("backend='nccl' runs on the card; CPU ranks take backend='gloo'")
    cards = torch.cuda.device_count()
    if size > cards:
        raise ValueError(
            f"backend='nccl' takes one card per rank: {size} ranks on {cards} card(s). "
            f"NCCL refuses two ranks on one device; ranks that share a card take "
            f"backend='gloo'")


def make_mesh(rank: int, size: int, init_method: str | None = None,
              backend: str = "nccl", device=None) -> Mesh:
    """Join rank `rank` of `size` to a process group and return its Mesh.

    `init_method`: the rendezvous every rank of the group passes, a
    `file://` store by default — `launch` makes one in a fresh temporary
    directory (a file store needs no free port, so concurrent groups on one
    machine cannot collide).  A lone rank may leave it None.  `device`:
    None or "cuda" (rank r takes card r % cards) or "cpu"."""
    _check_backend(size, backend, device)
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a group of {size}")
    dev = resolve_device(device)  # raises when cuda is asked for and missing
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if init_method is None:
        if size != 1:
            raise ValueError("make_mesh: every rank of a group must pass the same "
                             "init_method (launch() makes a file:// store)")
        fd, path = tempfile.mkstemp(prefix="lira_mesh_")
        os.close(fd)
        os.unlink(path)  # the store creates the file itself
        init_method = f"file://{path}"
    if not dist.is_initialized():
        dist.init_process_group(backend=backend, init_method=init_method,
                                world_size=size, rank=rank)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, size):
        raise RuntimeError("this process already belongs to another process group")
    return Mesh(rank=rank, size=size, device=dev, group=dist.group.WORLD, backend=backend)


def _rank_main(rank, size, init_method, backend, device, job_path, results):
    """One spawned rank: join the group, run the job, post (rank, ok, payload)."""
    try:
        with open(job_path, "rb") as f:
            fn, args, kwargs = pickle.load(f)
        if resolve_device(device).type == "cpu":
            torch.set_num_threads(1)  # several ranks share the host's cores
        mesh = make_mesh(rank, size, init_method, backend, device)
        out = fn(*args, mesh=mesh, **kwargs)
        # plain pickle, a copy of every tensor: torch's queue pickler would
        # share tensor storage by file descriptor, which dies with this rank
        results.put((rank, True, pickle.dumps(out) if rank == 0 else None))
    except BaseException as exc:  # reported to the parent, which re-raises it
        tb = traceback.format_exc()
        try:
            payload = pickle.dumps(exc)
        except Exception:
            payload = pickle.dumps(RuntimeError(repr(exc)))
        results.put((rank, False, (payload, tb)))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(n_shards: int, fn, *args, backend: str = "nccl", device=None, **kwargs):
    """Run `fn(*args, mesh=<the rank's Mesh>, **kwargs)` on `n_shards`
    spawned ranks and return rank 0's result.  `fn` and its arguments are
    pickled to every rank, so `fn` is a module-level function of a module
    that imports no more than it needs (every rank imports it).

    Any rank's exception is raised here (its traceback in a note), and a
    rank that dies without reporting fails the launch; the other ranks are
    then stopped.  Every rank's device follows `device` (see make_mesh)."""
    import torch.multiprocessing as mp

    _check_backend(n_shards, backend, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="lira_launch_") as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        # the job goes by file, in plain pickle: every rank unpickles its own
        # copy (Process arguments go through torch's pickler, which would put
        # tensor storage — a model's parameters — in shared memory, one
        # storage for all the ranks), and the ranks start together instead
        # of one by one as each drains a large argument from its pipe
        job_path = os.path.join(tmp, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump((fn, args, kwargs), f, protocol=pickle.HIGHEST_PROTOCOL)
        procs = [ctx.Process(target=_rank_main, daemon=False,
                             args=(r, n_shards, init_method, backend, device, job_path,
                                   results))
                 for r in range(n_shards)]
        for p in procs:
            p.start()
        reported, out, failure = set(), None, None
        done = False
        try:
            while len(reported) < n_shards and failure is None:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in reported and p.exitcode not in (None, 0)]
                    if not dead:
                        continue
                    try:  # a rank posts before it exits: its report may be in flight
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        failure = (RuntimeError(
                            f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                            f"without a result"), None)
                        continue
                reported.add(rank)
                if not ok:
                    failure = (pickle.loads(payload[0]), payload[1])
                elif rank == 0:
                    out = pickle.loads(payload)
            done = failure is None
        finally:
            if not done:  # a failed rank, or this process interrupted: stop the rest
                for p in procs:
                    if p.is_alive():
                        p.terminate()
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        exc, tb = failure
        if tb:
            exc.add_note(f"in a spawned rank:\n{tb}")
        raise exc
    return out


def _call_each(calls, *, mesh: Mesh):
    return [fn(*args, mesh=mesh, **kwargs) for fn, args, kwargs in calls]


def launch_many(n_shards: int, calls, backend: str = "nccl", device=None) -> list:
    """Several sharded calls in one set of ranks: `calls` is a list of
    (fn, args, kwargs), each run as in `launch`, in order, on every rank.
    Returns rank 0's results in call order (one spawn and one rendezvous
    for all of them)."""
    return launch(n_shards, _call_each, list(calls), backend=backend, device=device)
