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
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..device import resolve_device

DEFAULT_TIMEOUT_S = 300.0


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
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return DataParallelGroup(rank=rank, world_size=world_size, device=dev, backend=backend)


def shutdown() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


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
