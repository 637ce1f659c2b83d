"""Static analysis and the runtime transfer guard of the PyTorch port.

The JAX package's two recurring defect classes carry over to the port:
silent host<->device syncs (a ``float()`` or ``.item()`` on a CUDA tensor in
the coordinate-descent hot loop blocks the host until every queued kernel
has run) and discipline bugs (a hardcoded ``* 4`` itemsize, an ``except
Exception`` that eats a real error). This package is the JAX package's
``analysis/`` for the port, in the same two halves and with the same rule
ids, so ``# photon: ignore[Rn]`` and the four annotations read alike in both
packages:

- **static**: an AST linter (stdlib ``ast`` only; it imports neither torch
  nor JAX, and runs where neither is installed). Per-file rules R1-R8 —
  implicit device->host syncs in hot-loop modules, host syncs and tensor
  branches inside CUDA graph capture, dtype discipline, swallowed
  exceptions, non-atomic writes, NaN mishandling, unattributed wall-clock
  timing, and imports of JAX / the JAX package anywhere (or of torch in a
  torch-free module). Whole-program passes R9-R16 (``project.py`` +
  ``dataflow.py``): cross-thread races (R9), refusal-ledger consistency
  against README / the port's support-matrix test / ``refusals.json``
  (R10), the ``photon_*`` metric-name contract against ``CONTRACTS.md``
  (R11), unused suppressions (R12), lock-order cycles (R13), resources not
  released on every CFG path (R14), hazards in functions reachable from
  graph capture (R15), and fault-site drift against
  ``robust/fault_sites.json`` (R16). Run it with ``python -m
  photon_ml_tpu_torch.analysis`` (``--cache`` for the incremental fast
  path); its settings are ``config.py``'s.

- **runtime**: :func:`transfer_guard`, which the CD sweep enters, puts the
  card into CUDA's sync debug mode, so any synchronizing CUDA call in the
  block raises. Legitimate fetches go through :func:`logged_fetch` (or
  ``device.fetch``), explicit and counted in
  ``photon_device_fetch_bytes_total{site=}``, which lift the mode for their
  copy. ``runtime.py`` alone imports torch, and only when one of its names
  is first used.
"""

from .config import LintConfig, load_config
from .engine import (
    Finding,
    LintResult,
    analyze_paths,
    analyze_source,
    load_baseline,
    write_baseline,
    write_fault_inventory,
    write_refusal_inventory,
)
from .project import analyze_project
from .rules import RULES, explain_rule

_RUNTIME_NAMES = ("allow_transfers", "guard_level", "logged_fetch", "transfer_guard")


def __getattr__(name):
    # the runtime half imports torch: load it on first use, so the static
    # half (and `python -m photon_ml_tpu_torch.analysis`) imports without it
    if name in _RUNTIME_NAMES:
        from . import runtime

        return getattr(runtime, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Finding",
    "LintConfig",
    "LintResult",
    "RULES",
    "allow_transfers",
    "analyze_paths",
    "analyze_project",
    "analyze_source",
    "explain_rule",
    "guard_level",
    "load_baseline",
    "load_config",
    "logged_fetch",
    "transfer_guard",
    "write_baseline",
    "write_fault_inventory",
    "write_refusal_inventory",
]
