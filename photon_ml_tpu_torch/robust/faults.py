"""Deterministic fault injection at named sites.

The JAX package's ``robust/faults.py`` on the port. The fault-tolerance
claims ("kill at any coordinate-update boundary and resume reproduces the
run", "transient IO errors succeed within the retry budget") are only
claims until something can produce those failures on demand. IO boundaries
and checkpoint boundaries call :func:`check` with a site name, and an
activated injector raises either a transient :class:`InjectedIOError` (an
``OSError`` subclass, so the retry policy classifies it retryable) or a
:class:`SimulatedKill` (a ``BaseException`` subclass that no ``except
Exception`` on the way out can swallow: the closest a test can get to
``kill -9`` without leaving the process).

Default-off and cheap when off: :func:`check` and :func:`corrupt` are one
``is None`` test of a host-side module global, so a site on device tensors
costs no synchronize when no fault is active.

Activation:

- programmatic (tests): ``faults.configure("checkpoint.write:io:1x2")``
- environment (CLI runs): ``PHOTON_FAULTS=<spec>`` with optional
  ``PHOTON_FAULTS_SEED=<int>``; ``cli.train`` installs it at startup.

Spec grammar (comma-separated clauses)::

    SITE:KIND:WHEN
    KIND = io | kill | nan | delay[MS]
    WHEN = N      fire on the N-th call to the site (1-based)
         | NxM    fire on calls N..N+M-1 (M consecutive transient errors)
         | pF     fire on each call with probability F (seeded, so the
                  schedule is deterministic for a given seed)

``io.avro_read:io:1x2`` fails the first two Avro reads, then lets the third
succeed; ``cd.boundary_saved:kill:3`` kills the run right after the third
coordinate-update boundary's checkpoint. ``delay`` sleeps at the site
(``delay`` = 50 ms, ``delay200`` = 200 ms) and returns.

The ``nan`` kind never raises: it acts through :func:`corrupt`, which sites
holding tensors or arrays call as ``tree = faults.corrupt(site, tree)``.
When the schedule fires, NaN is planted at flat index 0 of every floating
leaf (torch tensors, on their device, and numpy arrays, copied; dicts,
lists and tuples are walked), exercising the numerical-divergence defenses
(solver rollback, coordinate rejection). ``solver.value_and_grad:nan:3``
corrupts the effective offsets of the third coordinate solve;
``coordinate.scores:nan:p0.3`` corrupts each coordinate's freshly computed
scores with probability 0.3.

The port's sites are listed in ``robust/fault_sites.json`` (the JAX package
keeps its own list in the repository's ``faults.json``).
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, List, Optional


class InjectedIOError(OSError):
    """Transient IO failure raised by the injector (retryable by policy)."""


class SimulatedKill(BaseException):
    """Simulated process kill. Deliberately NOT an ``Exception`` subclass:
    retry policies, event-emitter swallowing, and broad handlers must all
    let it through, exactly like a real SIGKILL would not be catchable."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    site: str
    kind: str  # "io" | "kill" | "nan" | "delay"
    at: int = 1  # first firing call index, 1-based ("NxM" / "N" forms)
    times: int = 1  # consecutive firings from ``at``
    prob: Optional[float] = None  # "pF" form: seeded per-call probability
    delay_s: float = 0.05  # "delay" kind: sleep length at the site

    def __post_init__(self):
        if self.kind not in ("io", "kill", "nan", "delay"):
            raise ValueError(
                f"fault kind must be io|kill|nan|delay[MS]: {self.kind!r}"
            )
        if self.prob is None and self.at < 1:
            raise ValueError(f"fault index is 1-based: {self.at}")
        if self.delay_s < 0:
            raise ValueError(f"fault delay must be >= 0: {self.delay_s}")


def parse_faults(spec: str) -> List[FaultSpec]:
    """Parse the ``PHOTON_FAULTS`` grammar (see module docstring)."""
    out: List[FaultSpec] = []
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"fault clause {clause!r}: expected SITE:KIND:WHEN "
                "(e.g. io.avro_read:io:1x2)"
            )
        site, kind, when = (p.strip() for p in parts)
        extra = {}
        if kind.startswith("delay"):
            ms = kind[len("delay"):]
            kind = "delay"
            if ms:
                extra["delay_s"] = float(ms) / 1e3
        if when.startswith("p"):
            out.append(
                FaultSpec(site=site, kind=kind, prob=float(when[1:]), **extra)
            )
        elif "x" in when:
            at, times = when.split("x", 1)
            out.append(
                FaultSpec(
                    site=site, kind=kind, at=int(at), times=int(times), **extra
                )
            )
        else:
            out.append(FaultSpec(site=site, kind=kind, at=int(when), **extra))
    return out


class FaultInjector:
    """Seeded, deterministic per-site fault schedule."""

    def __init__(self, specs: List[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._rng: Dict[str, random.Random] = {}
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_site.setdefault(s.site, []).append(s)

    def _schedule(self, site: str):
        """Count one call at ``site``; return (firing spec or None, call n)."""
        specs = self._by_site.get(site)
        if not specs:
            return None, 0
        with self._lock:
            n = self._calls.get(site, 0) + 1
            self._calls[site] = n
            for s in specs:
                if s.prob is not None:
                    # one rng per site, seeded by (seed, site): the schedule
                    # is a pure function of the seed, not of call interleaving
                    # across sites
                    rng = self._rng.get(site)
                    if rng is None:
                        rng = random.Random(f"{self.seed}:{site}")
                        self._rng[site] = rng
                    if rng.random() < s.prob:
                        return s, n
                elif s.at <= n < s.at + s.times:
                    return s, n
        return None, n

    def _raise(self, fire: FaultSpec, site: str, n: int) -> None:
        _count_injection(site, fire.kind)
        if fire.kind == "kill":
            raise SimulatedKill(f"injected kill at site {site!r} (call {n})")
        raise InjectedIOError(f"injected IO error at site {site!r} (call {n})")

    def _sleep(self, fire: FaultSpec, site: str) -> None:
        _count_injection(site, "delay")
        time.sleep(fire.delay_s)

    def hit(self, site: str) -> None:
        """Record one call at ``site``; raise if a spec says this call fails.
        ``delay`` specs sleep instead of raising; ``nan`` specs never fire
        here — a check-only site holds no arrays to corrupt; they act
        through :meth:`corrupt`."""
        fire, n = self._schedule(site)
        if fire is None or fire.kind == "nan":
            return
        if fire.kind == "delay":
            self._sleep(fire, site)
            return
        self._raise(fire, site, n)

    def corrupt(self, site: str, tree):
        """Record one call at ``site``; return ``tree`` with NaN planted into
        its floating-point array leaves when a ``nan`` spec fires (io/kill
        specs at a corrupt site raise exactly as :meth:`hit` would, delay
        specs sleep and pass the tree through untouched)."""
        fire, n = self._schedule(site)
        if fire is None:
            return tree
        if fire.kind == "delay":
            self._sleep(fire, site)
            return tree
        if fire.kind != "nan":
            self._raise(fire, site, n)
        _count_injection(site, "nan")
        return _plant_nan(tree)

    def calls(self, site: str) -> int:
        with self._lock:
            return self._calls.get(site, 0)


def _count_injection(site: str, kind: str) -> None:
    from .. import obs

    obs.current_run().registry.counter(
        "photon_faults_injected_total", "faults raised by the injector"
    ).labels(site=site, kind=kind).inc()


def _plant_nan(tree):
    """NaN planted at flat index 0 of every floating leaf: deterministic,
    so a given spec corrupts the same element on every run. Non-float and
    empty leaves pass through untouched. Tensors are corrupted on their
    device (a clone and one indexed write, no synchronize); numpy leaves
    are copied, never mutated in place. Dicts, lists and tuples are
    walked."""
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: _plant_nan(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plant_nan(v) for v in tree)
    if isinstance(tree, np.ndarray):
        if tree.size and np.issubdtype(tree.dtype, np.floating):
            out = tree.copy()
            out.ravel()[0] = np.nan
            return out
        return tree
    if isinstance(tree, torch.Tensor) and tree.numel() and tree.is_floating_point():
        out = tree.clone()
        out.view(-1)[:1].fill_(float("nan"))  # a fill: no upload, no host sync
        return out
    return tree


# the one module-global the hot path reads; None == disabled
_injector: Optional[FaultInjector] = None


def check(site: str) -> None:
    """Fault-injection hook: no-op (one ``is None`` test) unless an injector
    is installed. Call at IO / checkpoint boundaries, never in hot loops."""
    inj = _injector
    if inj is not None:
        inj.hit(site)


def corrupt(site: str, tree):
    """NaN-injection hook for sites holding tensors or arrays: pass-through
    (one ``is None`` test) unless an injector with a ``nan`` spec for this
    site decides the call fires. The schedule decision is host-side; the
    planting is a write on the tensor's device."""
    inj = _injector
    if inj is None:
        return tree
    return inj.corrupt(site, tree)


def active() -> bool:
    return _injector is not None


def configure(spec, seed: int = 0) -> FaultInjector:
    """Install an injector from a spec string or list of FaultSpecs."""
    global _injector
    specs = parse_faults(spec) if isinstance(spec, str) else list(spec)
    # lock-free publish by design: check()/corrupt() run on IO worker
    # threads and must stay a single is-None test, so workers snapshot the
    # reference once per call (inj = _injector) and CPython reference
    # assignment is atomic: a reader sees the old or the new injector
    # photon: thread-confined
    _injector = FaultInjector(specs, seed=seed)
    return _injector


def clear() -> None:
    global _injector
    _injector = None


def install_from_env(env=os.environ) -> Optional[FaultInjector]:
    """Install from ``PHOTON_FAULTS`` / ``PHOTON_FAULTS_SEED`` if set; clears
    any previous injector when the variable is absent (so a resumed CLI run
    without the env var starts clean)."""
    spec = env.get("PHOTON_FAULTS", "").strip()
    if not spec:
        clear()
        return None
    seed = int(env.get("PHOTON_FAULTS_SEED", "0"))
    return configure(spec, seed=seed)
