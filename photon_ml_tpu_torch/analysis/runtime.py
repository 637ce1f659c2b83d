"""Runtime companion to the static rules: the transfer guard over CUDA's
sync debug mode.

The static linter (R1) catches the implicit device->host syncs it can see in
the source; :func:`transfer_guard` catches the ones it cannot — attribute-
chained values, third-party calls, future regressions. Inside the guard the
card runs in CUDA's sync debug mode (``torch.cuda.set_sync_debug_mode``):
any synchronizing CUDA call — ``float(t)``, ``t.item()``, ``t.cpu()``,
masked indexing, ``nonzero``, a blocking ``.to()`` — raises. The convention,
enforced end to end:

- hot loops (the CD sweep) run inside ``transfer_guard()``;
- every legitimate fetch goes through :func:`logged_fetch` (or
  ``device.fetch``), which is explicit AND counted in the obs registry
  (``photon_device_fetch_bytes_total{site=...}``) and lifts the mode for its
  copy; :func:`device_get` is the uncounted explicit copy (the JAX
  package's ``jax.device_get``) for callers that count their own fetches;
- host->device staging inside the loop goes through :func:`device_put`, a
  non-blocking copy that synchronizes nothing (the JAX guard leaves
  uploads alone; torch's mode flags a blocking one);
- host-bound excursions inside a guarded loop (checkpoint writes) run under
  :func:`allow_transfers`.

``PHOTON_TRANSFER_GUARD`` overrides the guard level globally: ``off``
disables it (escape hatch for debugging), ``log`` demotes errors to
warnings (CUDA's ``"warn"`` mode), ``disallow`` (default) raises.

Three ways this guard differs from the JAX package's:

- It flags every synchronizing CUDA call, not only device->host copies: an
  op whose output shape depends on the data (masked indexing, ``nonzero``,
  ``unique``) syncs too. The JAX package has none, its shapes being static.
- The mode is process-wide, where JAX's guard is per thread. So the levels
  of the guards held are kept process-wide too (the innermost-entered one
  sets the mode), and a lift is a process-wide count under a lock: the
  first lift sets the mode to 0, the last restores the guard's. While any
  thread holds a lift, another thread's implicit sync passes unflagged.
- It acts on the card only: a guard for a CPU device (or in a torch built
  without CUDA, where the mode cannot be set) touches nothing, as the JAX
  guard is a no-op on its CPU backend. :func:`guard_level` reports the
  calling thread's innermost level either way.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch

from .. import obs

_LEVELS = ("off", "allow", "log", "disallow")
# torch.cuda.set_sync_debug_mode's setting for each effective level
_MODES = {"allow": 0, "log": "warn", "disallow": "error"}

_lock = threading.Lock()
# process-wide, under _lock: the levels of the card guards held, in the order
# entered (each entry a one-element list, removed by identity: threads may
# leave out of order), the lifts held, the mode found when the first guard
# entered (restored when the last leaves), and the mode this module set last
_guards: List[list] = []
_lifts = 0
_base = None
_current = None
# per thread: the levels of the guards and lifts entered, innermost last
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def guard_level() -> Optional[str]:
    """The calling thread's innermost active guard level, or None outside
    any guard."""
    stack = _stack()
    return stack[-1] if stack else None


def _guard_level(level: str) -> str:
    env = os.environ.get("PHOTON_TRANSFER_GUARD", "").strip().lower()
    if env:
        if env not in _LEVELS:
            raise ValueError(
                f"PHOTON_TRANSFER_GUARD={env!r}: expected one of {_LEVELS}"
            )
        return "allow" if env == "off" else env
    if level not in _LEVELS:
        raise ValueError(f"transfer_guard level {level!r}: expected one of {_LEVELS}")
    return "allow" if level == "off" else level


def _on_card(device) -> bool:
    if device is not None and torch.device(device).type != "cuda":
        return False
    return torch.cuda.is_available()


def _apply() -> None:
    """Set the mode the held guards and lifts call for (caller holds
    ``_lock``)."""
    global _current
    if not _guards:
        want = _base
    elif _lifts:
        want = 0
    else:
        want = _MODES[_guards[-1][0]]
    if want != _current:
        torch.cuda.set_sync_debug_mode(want)
        _current = want


@contextlib.contextmanager
def transfer_guard(level: str = "disallow", device=None) -> Iterator[None]:
    """Raise (``disallow``) or warn (``log``) on any synchronizing CUDA call
    in the block, on every thread of the process.

    ``device`` is the device the block works on (default: the card when
    torch has one); for a CPU device the guard only reports its level.
    Host->device staging through :func:`device_put` (a non-blocking copy)
    stays unrestricted, and explicit fetches (:func:`logged_fetch`,
    :func:`device_get`, ``device.fetch``) lift the mode for their copy: the point is that every sync in a guarded region
    is deliberate and counted, not that there are none."""
    global _base, _current
    effective = _guard_level(level)
    entry = [effective] if _on_card(device) else None
    stack = _stack()
    if entry is not None:
        with _lock:
            if not _guards:
                _base = _current = torch.cuda.get_sync_debug_mode()
            _guards.append(entry)
            _apply()
    stack.append(effective)
    try:
        yield
    finally:
        stack.pop()
        if entry is not None:
            with _lock:
                _guards[:] = [g for g in _guards if g is not entry]
                _apply()
                if not _guards:
                    _current = None


@contextlib.contextmanager
def _lifted() -> Iterator[None]:
    """Hold a lift: the mode is 0 from the first lift taken to the last
    released, across threads."""
    global _lifts
    with _lock:
        _lifts += 1
        if _lifts == 1 and _guards:
            _apply()
    try:
        yield
    finally:
        with _lock:
            _lifts -= 1
            if _lifts == 0 and _guards:
                _apply()


@contextlib.contextmanager
def allow_transfers() -> Iterator[None]:
    """Locally lift :func:`transfer_guard` — for host-bound excursions like
    checkpoint writes inside a guarded loop. Keep the block small; anything
    long-lived should instead fetch through :func:`logged_fetch`. The lift
    is process-wide (see the module's docstring)."""
    stack = _stack()
    stack.append("allow")
    try:
        with _lifted():
            yield
    finally:
        stack.pop()


def device_get(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` copied to the host (detached), the guard lifted for the
    copy, and not counted: the explicit fetch for callers that count their
    own (the solvers' ``SyncCounter``, ``device.fetch``). A host tensor
    comes back as it is."""
    with _lifted():
        return tensor.detach().cpu()


def device_put(value, device, dtype=None) -> torch.Tensor:
    """``value`` (a host scalar, array or tensor) on ``device``: the JAX
    package's ``jax.device_put``. Host->device staging is how data is meant
    to flow, and the guard leaves it alone: the copy is non-blocking, so it
    makes no host synchronize (a blocking upload waits for the whole stream,
    which the sync debug mode flags). A pageable source is staged by the
    driver before the call returns, so it may change afterwards."""
    return torch.as_tensor(value, dtype=dtype).to(device, non_blocking=True)


def _host_array(t: torch.Tensor) -> np.ndarray:
    host = device_get(t)
    # numpy has no bfloat16: widen on the host, after the copy
    return (host.float() if host.dtype == torch.bfloat16 else host).numpy()


def _fetch_tree(tree, counted: list):
    if isinstance(tree, torch.Tensor):
        counted[0] += tree.numel() * tree.element_size()
        return _host_array(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fetch_tree(x, counted) for x in tree)
    return tree


def logged_fetch(site: str, tree):
    """Explicit, counted device->host fetch of a tensor, or of a list or
    tuple of them.

    Returns host numpy in the same structure; numpy inputs (and anything
    else that is no tensor) pass through unchanged and are not counted.
    ``site`` labels the transfer in ``photon_device_fetch_bytes_total`` so
    a sweep's fetch budget is attributable line-item by line-item: the
    bytes counted are the tensors' own (``numel * element_size``)."""
    counted = [0]
    host = _fetch_tree(tree, counted)
    if counted[0]:
        obs.add_device_fetch_bytes(site, counted[0])
    return host
