"""Process groups for tensor and data parallelism, over ``torch.distributed``
(port of metavoice_tpu/parallel/mesh.py).

The JAX package lays its devices out as a 2-D (data, tensor) mesh inside
one program, and GSPMD or ``shard_map`` emits the collectives. Here, as in
Megatron and PyTorch's own tensor parallelism, each rank is a process with
one device: ``make_mesh`` cuts the world into the same grid, rank r at data
index ``r // tp`` and tensor index ``r % tp`` (JAX's ``reshape(n // tp,
tp)``), and gives each rank its tensor group (the ranks that share one
model's shards and reduce together) and its data group.

Start the ranks with :func:`spawn` (one process a rank, the ``spawn``
start method, a ``file://`` store in a temporary directory) or with
``torchrun``, whose ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
:func:`initialize_distributed` reads. A rank's device is ``cuda:LOCAL_RANK``
by default, or the one its caller gives; with no card nothing here picks
the CPU unless the caller asks for it (``device="cpu"``). NCCL, the default
backend on the card, takes one card a rank; two ranks on one card (a test of the TP path
on a machine with one card) take ``backend="gloo"``, which is never chosen
silently.

``local_batch_to_global`` has no counterpart: each rank keeps its own rows
of the batch (:func:`process_batch_slice` says which), and no global array
is ever assembled.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from metavoice_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
TENSOR_AXIS = "tensor"
DEFAULT_TIMEOUT_S = 600.0  # a collective that waits this long raises
DEADLINE_TIMEOUTS = 4  # spawn's default deadline for a whole run, in collective timeouts
# the collective timeout initialize_distributed gave the world, which make_mesh gives each group it makes:
# torch's new_group would otherwise take its own default (30 minutes for gloo), whatever the world's
_world_timeout_s = DEFAULT_TIMEOUT_S


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, tensor) grid.

    ``tensor_group`` / ``data_group``: the process groups of this rank's row
    and column of the grid (None in a world of one process);
    ``tensor_ranks``: the global ranks of its tensor group, tensor index 0
    first; ``device``: the rank's device."""

    tensor_parallel: int
    data_parallel: int
    tensor_rank: int
    data_rank: int
    tensor_ranks: tuple[int, ...]
    tensor_group: object | None
    data_group: object | None
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data_parallel, TENSOR_AXIS: self.tensor_parallel}

    @property
    def leader(self) -> bool:
        """Tensor index 0: the rank that reads inputs and writes outputs."""
        return self.tensor_rank == 0

    def batch_rows(self, global_batch: int) -> tuple[int, int]:
        """[start, stop) rows of a global batch that this rank's data index holds."""
        return process_batch_slice(global_batch, process_index=self.data_rank, process_count=self.data_parallel)


def rank_device(device=None) -> torch.device:
    """``device``, else ``cuda:LOCAL_RANK``; with no card and no ``device``
    it raises: a rank runs on the CPU only when its caller asks for it."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('there is no card for this rank: pass device="cpu" to run it on the CPU')
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def initialize_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    timeout: float = DEFAULT_TIMEOUT_S,
) -> None:
    """``torch.distributed.init_process_group``, a no-op for one process or
    once the default group exists. Unset arguments come from ``torchrun``'s
    environment (``WORLD_SIZE``, ``RANK``, ``env://``); the backend defaults
    to NCCL where there is a card, else gloo. Every collective of the group
    raises after ``timeout`` seconds, so a dead rank cannot hang the others;
    so do those of the groups :func:`make_mesh` makes."""
    global _world_timeout_s
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if world_size <= 1 or dist.is_initialized():
        return
    _world_timeout_s = timeout
    rank = int(os.environ["RANK"]) if rank is None else rank
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))


def local_mesh(device=None) -> Mesh:
    """The grid of a single process, with no groups: the leader of itself."""
    return Mesh(1, 1, 0, 0, (0,), None, None, rank_device(device))


def make_mesh(tensor_parallel: int = 1, *, device=None) -> Mesh:
    """This rank's (data, tensor) grid over the initialized world.

    ``tensor_parallel`` must divide the world size; the data axis takes the
    rest. Every rank makes every group, in the same order (``new_group`` is
    collective), so every rank must call this, with the same argument.
    Without a process group only ``tensor_parallel=1`` is possible. The
    groups' collectives time out as the world's do (the timeout given to
    :func:`initialize_distributed`, else ``DEFAULT_TIMEOUT_S``)."""
    if not dist.is_initialized():
        if tensor_parallel != 1:
            raise RuntimeError(
                f"tensor_parallel={tensor_parallel} needs one process a rank in an initialized process group: "
                "start the ranks with metavoice_tpu_torch.parallel.mesh.spawn, or under torchrun and call "
                "initialize_distributed()"
            )
        return local_mesh(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % tensor_parallel:
        raise ValueError(f"tensor_parallel={tensor_parallel} does not divide {world} ranks")
    tp, dp = tensor_parallel, world // tensor_parallel
    timeout = datetime.timedelta(seconds=_world_timeout_s)
    tensor_group = data_group = None
    for d in range(dp):
        ranks = [d * tp + t for t in range(tp)]
        group = dist.new_group(ranks, timeout=timeout)
        if rank in ranks:
            tensor_group, tensor_ranks = group, tuple(ranks)
    for t in range(tp):
        ranks = [d * tp + t for d in range(dp)]
        group = dist.new_group(ranks, timeout=timeout)
        if rank in ranks:
            data_group = group
    return Mesh(tp, dp, rank % tp, rank // tp, tensor_ranks, tensor_group, data_group, rank_device(device))


def check_topology(tensor_parallel: int, world_size: int, local_world_size: int) -> None:
    """The JAX package's ``make_multihost_mesh`` rule, on counts (a caller
    across hosts passes torchrun's ``WORLD_SIZE`` and
    ``LOCAL_WORLD_SIZE``): a tensor group stays inside one host.

    The grid is host-major (ranks numbered host by host), so a tensor group
    of at most the ranks a host holds, dividing them, never straddles two
    hosts: its reductions, two a layer, stay on the host's own links, and
    only the data axis crosses the network between hosts."""
    if tensor_parallel > local_world_size or local_world_size % tensor_parallel:
        raise ValueError(
            f"tensor_parallel={tensor_parallel} does not pack into the {local_world_size} ranks local to one "
            "host: tensor groups would straddle hosts and their collectives would cross the network between "
            "them. Shard the batch (data axis) across hosts instead."
        )
    if world_size % tensor_parallel:
        raise ValueError(f"tensor_parallel={tensor_parallel} does not divide {world_size} ranks")


def process_batch_slice(global_batch: int, *, process_index: int | None = None,
                        process_count: int | None = None) -> tuple[int, int]:
    """[start, stop) rows of the global batch this process owns (by
    default its rank in the default group)."""
    initialized = dist.is_initialized()
    pi = process_index if process_index is not None else dist.get_rank() if initialized else 0
    pc = process_count if process_count is not None else dist.get_world_size() if initialized else 1
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} processes")
    per = global_batch // pc
    return pi * per, (pi + 1) * per


def _rank_main(rank: int, world: int, backend: str, devices: list, timeout: float, out_dir: str) -> None:
    """One spawned rank: torchrun's environment, its device, the process
    group, then ``fn(rank, *args)`` as the parent pickled them into
    ``out_dir``; its return value (or its exception) is pickled there for
    the parent."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # the CPU ranks share the host's cores rather than each taking all of them
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // devices.count(devices[rank])))
        initialize_distributed(backend, init_method=f"file://{os.path.join(out_dir, 'store')}", world_size=world,
                               rank=rank, timeout=timeout)
        out = fn(rank, *args)
    except BaseException as e:
        try:  # stamped: a rank that fails first makes the others fail in their collectives
            with open(os.path.join(out_dir, f"error_{rank}.pkl"), "wb") as f:
                pickle.dump((time.time(), e), f)
        except Exception:  # an exception that does not pickle: the parent reports the traceback
            pass
        raise
    with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


ERROR_GRACE_S = 5.0  # how long spawn waits for the other ranks' errors once one rank has failed
# what a rank raises when a peer's process has gone: never the first failure when a rank raised its own
PEER_LOST = ("closed by peer", "reset by peer", "Broken pipe")


def _rank_errors(ctx, out_dir: str, world_size: int) -> list:
    """The (timestamp, exception) of every rank that wrote one. The parent
    learns of the first rank to exit, which need not be the first to fail:
    it waits up to ``ERROR_GRACE_S`` for the ranks still alive to end (a
    rank writes its error before it exits), then reads every error file."""
    end = time.monotonic() + ERROR_GRACE_S
    while any(p.is_alive() for p in ctx.processes) and time.monotonic() < end:
        time.sleep(0.05)
    errors = []
    for r in range(world_size):
        path = os.path.join(out_dir, f"error_{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                errors.append(pickle.load(f))
    return errors


def first_failure(errors: list) -> BaseException:
    """The failure that ended a world, from each failed rank's (timestamp,
    exception): the earliest a rank raised of its own. A rank that lost its
    connection to a peer (``PEER_LOST``) failed because that peer had
    already failed, whatever the order of their timestamps (a rank stamps
    its error only once it has unwound, so the peer whose connection it
    closed can stamp first); such an error is chosen only when there is no
    other."""
    own = [te for te in errors if not any(m in str(te[1]) for m in PEER_LOST)]
    return min(own or errors, key=lambda te: te[0])[1]


def _device_name(device) -> str:
    """A rank's device by name; "cuda" alone is the first card."""
    dev = torch.device(device)
    return str(torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev)


def spawn(fn, world_size: int, *, args: tuple = (), backend: str | None = None, devices: list | None = None,
          timeout: float = DEFAULT_TIMEOUT_S, deadline: float | None = None) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes, one a rank,
    in one process group -> each rank's return value, in rank order.

    ``fn`` is a module-level function (it is pickled by name). ``devices``:
    one a rank (default ``cuda:0`` ... ``cuda:N-1``; with no card the caller
    asks for CPU ranks, ``["cpu"] * N``, or this raises). ``backend``: NCCL
    for card ranks, gloo for CPU ranks by default; NCCL takes one card a
    rank, so two ranks on one card raise ``ValueError`` unless
    ``backend="gloo"`` is asked for. ``timeout``: the collective timeout of
    the world and of the groups ``make_mesh`` makes; ``deadline``: seconds
    the whole run may take (None: ``DEADLINE_TIMEOUTS`` collective timeouts;
    ``math.inf``: no limit, for a server), after which the ranks are stopped
    and ``TimeoutError`` raised. A rank that raises ends the run: the other
    ranks are stopped, and the first exception any rank raised of its own is
    raised here (:func:`first_failure`, chained to a failed rank's
    traceback). The processes start with
    the ``spawn`` method (a parent that has used CUDA cannot fork), and the
    group meets through a ``file://``
    store in a new temporary directory, so runs side by side never share a
    port. ``fn`` and ``args`` reach the ranks through a plain pickle in that
    directory: the caller's tensors are copied, never moved into shared
    memory (``torch.multiprocessing``'s own pickling does that in place,
    under any other thread that reads them). Build the CUDA kernels once in
    the parent first (``ops/_build.kernels()``), or every rank builds them
    at once."""
    import torch.multiprocessing as mp

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f'there is no card for the {world_size} ranks: pass devices=["cpu"] * {world_size} '
                               '(device="cpu" a rank) to run them on the CPU')
        if world_size > torch.cuda.device_count():
            raise ValueError(f"{world_size} ranks need {world_size} cards, this machine has "
                             f"{torch.cuda.device_count()}")
        devices = [f"cuda:{r}" for r in range(world_size)]
    devices = [_device_name(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    on_card = all(d.startswith("cuda") for d in devices)
    backend = backend or ("nccl" if on_card else "gloo")
    if backend == "nccl" and not on_card:
        raise ValueError(f"NCCL ranks need a card each, got devices {devices}")
    if backend == "nccl" and len(set(devices)) < len(devices):
        raise ValueError(f"NCCL cannot hold two ranks on one device ({devices}): pass backend='gloo' to run them "
                         "on one card")
    out_dir = tempfile.mkdtemp(prefix="mv_spawn_")
    try:
        with open(os.path.join(out_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(_rank_main, args=(world_size, backend, devices, timeout, out_dir),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = DEADLINE_TIMEOUTS * timeout if deadline is None else deadline
        end = time.monotonic() + deadline
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > end:
                    raise TimeoutError(f"the {world_size} ranks did not finish within {deadline} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:  # an exit, e.g. SystemExit, too
            errors = _rank_errors(ctx, out_dir, world_size)
            if errors:  # the first failure, not a peer's failed collective after it
                raise first_failure(errors) from e
            raise
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
