"""Crash-safe file writes: write-to-temp + fsync + atomic rename.

The Spark reference never thinks about torn writes — HDFS output committers
rename a finished task directory into place. This package writes files
directly, so every model / manifest / stats write is one preemption away
from a partial file that a later ``load_game_model`` happily half-parses.
This module is the single choke point that closes that hole: all durable
file creation in ``io/`` and ``robust/`` routes through :func:`atomic_write`
(enforced by lint rule R5), which guarantees a reader sees either the old
complete file or the new complete file, never a prefix.

The sequence is the classic POSIX recipe: write ``<path>.tmp.<pid>``, flush,
``os.fsync`` the file (data durable before the name flips), ``os.replace``
onto the final name (atomic within a filesystem), then best-effort fsync the
parent directory so the rename itself survives a power cut. ``fsync=False``
skips both fsyncs for callers on hot paths that only need atomicity against
crashes of THIS process, not media durability.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import IO, Iterator, Optional


def _fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory (persists a rename); some platforms
    and filesystems refuse O_RDONLY dir fds — treat that as non-fatal."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_write(
    path: str,
    mode: str = "w",
    encoding: Optional[str] = None,
    fsync: bool = True,
) -> Iterator[IO]:
    """Context manager yielding a file object whose contents replace ``path``
    atomically on clean exit; on error the temp file is removed and ``path``
    is untouched.

    ``mode`` must be a fresh-write mode ('w', 'wb'); append modes make no
    sense under replace semantics."""
    if "a" in mode or "+" in mode or "r" in mode:
        raise ValueError(f"atomic_write needs a fresh-write mode, got {mode!r}")
    if encoding is None and "b" not in mode:
        encoding = "utf-8"
    directory = os.path.dirname(path) or "."
    tmp = os.path.join(directory, f"{os.path.basename(path)}.tmp.{os.getpid()}")
    # photon: ignore[R5] — this IS the atomic-write helper (temp then replace)
    f = open(tmp, mode, encoding=encoding)
    try:
        yield f
        f.flush()
        if fsync:
            os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
        if fsync:
            _fsync_dir(directory)
    except BaseException:
        # leave no droppings: close and remove the temp, keep ``path`` as-is
        try:
            f.close()
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    with atomic_write(path, "wb", fsync=fsync) as f:
        f.write(data)


def atomic_write_text(path: str, text: str, fsync: bool = True) -> None:
    with atomic_write(path, "w", fsync=fsync) as f:
        f.write(text)


def atomic_write_json(path: str, doc, fsync: bool = True, **dump_kwargs) -> None:
    with atomic_write(path, "w", fsync=fsync) as f:
        json.dump(doc, f, **dump_kwargs)
        f.write("\n")
