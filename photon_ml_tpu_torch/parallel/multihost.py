"""Multi-process runtime: joining a ``torch.distributed`` group, row splits,
replication, and a launcher for a group of local processes.

Counterpart of the JAX package's ``parallel/multihost.py``. There
``jax.distributed.initialize`` joins processes that each drive some devices
of one global mesh; here every rank is one process with one device, joined
by ``torch.distributed.init_process_group``: NCCL on the card (one rank per
card: NCCL refuses two ranks of one communicator on the same card), gloo on
the CPU or, staged through the host, for several ranks sharing one card.

Run under torchrun (``torchrun --standalone --nproc-per-node=N script.py``
and ``initialize("nccl")`` in the script, which reads ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``), or start the ranks with ``spawn``.

``cli.train`` and ``cli.score`` join through ``initialize_from_spec`` (``--distributed
coordinator=HOST:PORT,process=I,n=P``, or ``auto`` for torchrun's
environment). The backend follows from the devices (``choose_backend``):
NCCL where every rank on the host has a card of its own, gloo where ranks
share a card or run on the CPU. Over NCCL a gloo side group is made as
well, so that the object collectives (``allgather_object``,
``broadcast_object``: small pickled planning data, never row data) and the
bounded barrier of ``robust/distributed.py`` (``monitored_barrier``, a gloo
operation) run on the host beside the card's collectives. Both object
collectives are guarded: with a collective budget armed, every rank first
meets at a bounded barrier, so a dead peer is a typed error and not a hang.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing
import os
import shutil
import time
import traceback
import uuid
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device

DEFAULT_TIMEOUT_S = 300.0

# the group this process joined through initialize(), and its gloo side
# group (None: the default group is gloo itself)
_group = None
_side_group = None


def initialize(
    backend: str,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
):
    """Join the default process group and return this rank's
    ``DataParallelGroup``.

    ``backend`` is always explicit: ``"nccl"`` or ``"gloo"``. Without
    ``rank`` / ``world_size`` they come from torchrun's ``RANK`` /
    ``WORLD_SIZE`` (and ``init_method`` defaults to ``env://``, which reads
    ``MASTER_ADDR`` / ``MASTER_PORT``). ``device`` is ``"cuda"`` (the
    default: rank r takes ``cuda:(LOCAL_RANK % device_count)``, LOCAL_RANK
    defaulting to r) or ``"cpu"``. Collectives time out after
    ``timeout_s``."""
    import torch.distributed as dist

    from .mesh import DataParallelGroup

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a CUDA device")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        rank=rank,
        world_size=world_size,
        timeout=timeout,
    )
    global _group, _side_group
    # every rank makes the side group, in the same order: a collective call
    _side_group = dist.new_group(backend="gloo", timeout=timeout) if backend == "nccl" else None
    _group = DataParallelGroup(rank=rank, world_size=world_size, device=dev, backend=backend)
    return _group


def choose_backend(device, world_size: int) -> str:
    """The backend the devices call for: gloo on the CPU; on the card NCCL
    when every rank of this host has a card of its own, else gloo (NCCL
    refuses two ranks of one communicator on one card). The ranks on this
    host are ``LOCAL_WORLD_SIZE`` (torchrun sets it), else the whole world
    (the ``coordinator=...`` spec starts every rank on one host)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def parse_spec(spec: str) -> dict:
    """``coordinator=HOST:PORT,process=I,n=P`` -> its fields (the JAX
    package's spec); unknown keys raise."""
    parts = dict(p.split("=", 1) for p in spec.split(",") if p)
    unknown = set(parts) - {"coordinator", "process", "n"}
    if unknown:
        raise ValueError(
            f"unknown --distributed keys {sorted(unknown)}; "
            "expected coordinator=HOST:PORT,process=I,n=P"
        )
    missing = {"coordinator", "process", "n"} - set(parts)
    if missing:
        raise ValueError(f"--distributed {spec!r} lacks {sorted(missing)}; expected coordinator=HOST:PORT,process=I,n=P")
    return {"coordinator": parts["coordinator"], "process": int(parts["process"]), "n": int(parts["n"])}


def initialize_from_spec(spec: str, device=None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the group a CLI's ``--distributed`` names and return this
    rank's ``DataParallelGroup``: ``coordinator=HOST:PORT,process=I,n=P``
    meets at ``tcp://HOST:PORT`` (process 0 listens there), ``auto`` reads
    torchrun's ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``.
    The backend follows from ``device`` (``choose_backend``); a rank whose
    card is missing raises (``resolve_device``). Joined already: the group
    this process holds."""
    import torch.distributed as dist

    if _group is not None and dist.is_initialized():
        return _group
    if spec == "auto":
        rank, world, init_method = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://"
    else:
        fields = parse_spec(spec)
        rank, world, init_method = fields["process"], fields["n"], f"tcp://{fields['coordinator']}"
        if not 0 <= rank < world:
            raise ValueError(f"--distributed process={rank} outside n={world}")
    return initialize(
        choose_backend(device, world), rank=rank, world_size=world, init_method=init_method,
        device=device, timeout_s=timeout_s,
    )


def current_group():
    """The ``DataParallelGroup`` this process joined through
    ``initialize``, or None."""
    import torch.distributed as dist

    return _group if _group is not None and dist.is_initialized() else None


def side_group():
    """The gloo group of the object collectives and the bounded barrier:
    the side group over NCCL, None (the default group) over gloo."""
    return _side_group


def shutdown() -> None:
    import torch.distributed as dist

    global _group, _side_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _group = _side_group = None


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on process 0, the only process that writes models and
    summaries (the reference's driver-writes-to-HDFS role)."""
    return process_index() == 0


def host_row_range(
    n_rows: int, index: Optional[int] = None, count: Optional[int] = None
) -> Tuple[int, int]:
    """This process's contiguous [start, stop) slice of a global row count
    (per-host input split; balanced to within one row)."""
    i = process_index() if index is None else index
    p = process_count() if count is None else count
    base, rem = divmod(n_rows, p)
    start = i * base + min(i, rem)
    stop = start + base + (1 if i < rem else 0)
    return start, stop


def equal_host_share(n_rows: int, count: Optional[int] = None) -> int:
    """The common per-process row count every process pads its share to:
    ``ceil(n_rows / P)`` (zero-weight rows, invisible to the objectives)."""
    p = process_count() if count is None else count
    return -(-n_rows // p)


def allgather_object(obj: Any) -> list:
    """One picklable object from every process, in process order, on every
    process (one process: ``[obj]``). For planning data (entity tables,
    shape agreements, checkpoint confirmations), not row data. Guarded:
    with a collective budget armed, a bounded barrier comes first
    (``robust.distributed.guard_collective``)."""
    if process_count() == 1:
        return [obj]
    import torch.distributed as dist

    from ..robust import distributed as robust_dist

    robust_dist.guard_collective("allgather_object")
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=_side_group)
    return out


def broadcast_object(obj: Any) -> Any:
    """Process 0's ``obj`` on every process (the others' is ignored): one
    copy of a coordinator-owned payload, as a checkpoint's models. One
    process: ``obj``. Guarded as ``allgather_object`` is."""
    if process_count() == 1:
        return obj
    import torch.distributed as dist

    from ..robust import distributed as robust_dist

    robust_dist.guard_collective("broadcast_object")
    box = [obj if process_index() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=_side_group)
    return box[0]


def fully_replicate(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Entity- or row-sharded tensors made whole on every rank: each
    tensor's dim-0 parts from every rank in rank order, by one slot gather
    (exact: each slot has one nonzero writer). One rank: the identity."""
    return group.gather_rows(tensors)


# ------------------------------------------------------------------ launcher


def _resolve(fn_ref: Union[str, Callable]) -> Callable:
    if callable(fn_ref):
        return fn_ref
    module, _, name = fn_ref.partition(":")
    return getattr(importlib.import_module(module), name)


def _rank_main(fn_ref, rank, world, backend, device, init_method, out_dir, timeout_s):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    out = Path(out_dir)
    try:
        args = torch.load(out / "args.pt", weights_only=False)
        group = initialize(
            backend, rank=rank, world_size=world, init_method=init_method,
            device=device, timeout_s=timeout_s,
        )
        result = _resolve(fn_ref)(group, *args)
        tmp = out / f"rank{rank}.pt.tmp"
        torch.save(result, tmp)
        os.replace(tmp, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        shutdown()


def spawn(
    fn_ref: Union[str, Callable],
    world: int,
    backend: str,
    devices: str,
    args: tuple = (),
    timeout_s: float = 120.0,
    store_dir: Union[str, Path, None] = None,
) -> list:
    """Run ``fn(group, *args)`` on ``world`` fresh processes (the ``spawn``
    start method) joined over ``backend``; return each rank's result, in
    rank order.

    ``fn_ref`` is a module-level function or ``"module:function"``; the
    children import it anew, and ``args`` and the results pass through
    files in the run's directory, so they must pickle (move tensors to the
    CPU first). ``devices`` is the ranks' device kind:
    ``"cpu"``, or ``"cuda"`` (rank r takes ``cuda:(r % device_count)``). The
    group meets at a ``file://`` store in
    ``store_dir``, where the results are passed back as well. Every rank's
    collectives time out after ``timeout_s``, and the whole run after
    ``timeout_s`` of wall time: then every child is killed and
    ``TimeoutError`` names the ranks still running. A rank that fails
    stops the others, and ``RuntimeError`` carries its traceback."""
    if store_dir is None:
        raise ValueError("spawn needs a store_dir for its file store and results")
    run_dir = Path(store_dir) / f"spawn-{uuid.uuid4().hex}"
    run_dir.mkdir(parents=True)
    init_method = f"file://{run_dir / 'store'}"
    # the arguments travel by file: a child that dies before reading its
    # start-up pipe must not leave a large write to it blocking here
    torch.save(tuple(args), run_dir / "args.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn_ref, r, world, backend, devices, init_method, str(run_dir), timeout_s),
            name=f"rank{r}",
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                running = [r for r, c in enumerate(codes) if c is None]
                raise TimeoutError(f"ranks {running} of {world} still running after {timeout_s:.0f}s")
            time.sleep(0.05)
        if failed:
            # a peer of the failed rank may fail in its next collective and
            # exit first: give every rank a moment, then report them all
            grace = time.monotonic() + 5.0
            while any(p.exitcode is None for p in procs) and time.monotonic() < grace:
                time.sleep(0.05)
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            errs = [
                (run_dir / f"rank{r}.err").read_text()
                if (run_dir / f"rank{r}.err").is_file() else f"exit code {codes[r]}"
                for r in failed
            ]
            raise RuntimeError(f"ranks {failed} of {world} failed:\n" + "\n".join(errs))
        return [torch.load(run_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        shutil.rmtree(run_dir, ignore_errors=True)
