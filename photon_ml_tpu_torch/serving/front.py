"""Least-loaded replica front: N ``cli serve`` replicas behind one submit
surface, with health-checked routing and idempotent failover (the JAX
package's ``serving/front.py`` on the port, copied: it speaks the
JSON-lines protocol and holds no device state, so it fronts replicas of
either package).

The fleet's horizontal axis: every replica serves the same snapshot store
(same JSON-lines protocol, same ``model=`` routing), and the front holds
a pool of persistent connections per replica, routing each request to the
live channel with the fewest requests in flight. The pool size matters
because the JSON-lines protocol answers in order PER CONNECTION — a
replica scores one request per connection at a time — so the front's
concurrency into one replica equals its connection count:
``connections_per_replica`` channels keep the replica's microbatcher fed
enough to actually fill batches (one channel caps every batch at one
row). Scoring is a pure function of
(snapshot, request), so a request is safe to replay: when a replica dies
mid-request — connection reset, EOF, or an injected ``serving.replica``
fault — every request still outstanding on it is **resubmitted verbatim**
(same ``trace_id``, the idempotency key: a fleet-merged trace shows the
same id hopping replicas) to the survivors. The chaos drill this enables:
kill a replica under open-loop load and ZERO requests end without a
response — each one either scores on a survivor or comes back as a typed
shed (``no_replica`` when the whole fleet is down, ``resubmit_budget``
when a request has been through too many dying replicas).

Health: a replica is routable when its connection is up AND (when a
``healthz`` address is given) its ``/healthz`` answers 200 — a replica
answering 503 (mid-refresh flip, or shedding past its overload threshold)
is *drained*: no new requests, in-flight ones finish. A background
maintenance thread polls health and reconnects dead replicas, so a
restarted replica rejoins the rotation without operator action.

Fault sites: ``serving.route`` fires at every routing decision (an
injected error sheds the request, typed ``route``); ``serving.replica``
fires at every replica send (an injected IO error is a replica connection
dying mid-request — the failover drill without killing a process).

Addresses are TCP ``host:port`` only — balancing AF_UNIX replicas is
refused through the support-matrix ledger (``plan.check_fleet_composition``):
an AF_UNIX path names one kernel socket on one host, so there is no fleet
to balance. Front metrics: ``photon_serving_route_total{replica=}``,
``photon_serving_replica_up{replica=}``,
``photon_serving_failover_resubmits_total``, and
``photon_serving_front_sheds_total{reason=}``.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import urllib.error
import urllib.request
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

from .. import obs
from ..plan import check_fleet_composition
from ..robust import faults
from .batcher import ShedError
from .engine import ScoreRequest
from .server import MAX_REQUEST_LINE_BYTES, BadRequestError, _count_bad_request

_ROUTE_HELP = "requests routed to a replica by the least-loaded front"
_FRONT_SHED_HELP = (
    "requests the front refused with a typed shed response "
    "(no_replica / route / resubmit_budget / front_closed)"
)


class _Pending:
    """One in-flight request: the serialized line (resent verbatim on
    failover — same trace_id), its Future, and its resubmit count."""

    __slots__ = ("payload", "fut", "model", "trace_id", "resubmits")

    def __init__(self, payload: bytes, fut: Future, model, trace_id: str):
        self.payload = payload
        self.fut = fut
        self.model = model
        self.trace_id = trace_id
        self.resubmits = 0


class _Replica:
    """One replica connection: socket + in-order outstanding queue. The
    JSON-lines protocol answers in request order per connection, so the
    reader matches responses by position. ``gen`` increments on every
    disconnect so a stale reader (or a racing send) can tell its
    connection was replaced."""

    def __init__(self, name: str, host: str, port: int, healthz: Optional[str]):
        self.name = name
        self.host = host
        self.port = port
        self.healthz = healthz
        self.lock = threading.Lock()
        self.sock: Optional[socket.socket] = None
        self.rfile = None
        self.up = False
        self.healthy = True
        self.gen = 0
        self.outstanding: "deque[_Pending]" = deque()


_front_ids = itertools.count(1)


class LeastLoadedFront:
    """Route requests across N scoring replicas, least in-flight first.

    ``replicas`` is a list of TCP ``host:port`` addresses (each a
    ``cli serve --listen`` replica over the same snapshot store);
    ``healthz`` optionally gives each replica's introspection address
    (``host:status_port``, or None) for 503-draining. ``submit`` /
    ``score`` mirror :class:`~photon_ml_tpu_torch.serving.server.ScoringServer`'s
    surface (so ``loadgen.run_open_loop`` drives a fleet unchanged);
    ``submit_doc`` is the raw JSON-document surface the pass-through socket
    handler (``serve_front_socket``) and the failover path share.

    ``connections_per_replica`` opens K independent channels to each
    address (module docstring: the serial-per-connection protocol makes K
    the front's concurrency into one replica). Channels beyond the first
    are named ``host:port#k`` everywhere a replica name surfaces (the
    ``replica=`` metric label, ``replica_states()``); each fails over
    independently, so one torn channel resubmits only its own
    outstanding requests."""

    def __init__(
        self,
        replicas: Sequence[str],
        healthz: Optional[Sequence[Optional[str]]] = None,
        connect_timeout: float = 2.0,
        health_poll_seconds: float = 0.25,
        max_resubmits: int = 5,
        request_timeout: float = 60.0,
        connections_per_replica: int = 1,
    ):
        if not replicas:
            raise ValueError("LeastLoadedFront needs at least one replica")
        check_fleet_composition((), front_replicas=replicas)
        if healthz is not None and len(healthz) != len(replicas):
            raise ValueError("healthz must parallel replicas (None entries ok)")
        if int(connections_per_replica) < 1:
            raise ValueError("connections_per_replica must be >= 1")
        self.connect_timeout = float(connect_timeout)
        self.health_poll_seconds = float(health_poll_seconds)
        self.max_resubmits = int(max_resubmits)
        self.request_timeout = float(request_timeout)
        self._id = f"fr{os.getpid():x}-{next(_front_ids)}"
        self._req_seq = itertools.count(1)
        self._closed = threading.Event()
        self._replicas: List[_Replica] = []
        for i, addr in enumerate(replicas):
            host, _, port = str(addr).rpartition(":")
            hz = healthz[i] if healthz is not None else None
            for k in range(int(connections_per_replica)):
                name = str(addr) if k == 0 else f"{addr}#{k}"
                self._replicas.append(_Replica(name, host, int(port), hz))
        self._reader_threads: List[threading.Thread] = []
        for r in self._replicas:
            self._connect(r)
        self._maintainer = threading.Thread(
            target=self._maintain, name="photon-serving-front", daemon=True
        )
        self._maintainer.start()

    # -- connections ----------------------------------------------------------

    def _set_up_gauge(self, r: _Replica, value: int) -> None:
        obs.current_run().registry.gauge(
            "photon_serving_replica_up",
            "replica liveness as seen by the front (1 routable, 0 down)",
        ).labels(replica=r.name).set(value)

    def _connect(self, r: _Replica) -> bool:
        """(Re)open one replica connection and start its reader. Failures
        leave the replica down — the maintenance thread retries."""
        try:
            sock = socket.create_connection(
                (r.host, r.port), timeout=self.connect_timeout
            )
        except OSError:
            self._set_up_gauge(r, 0)
            return False
        try:
            sock.settimeout(None)
            with r.lock:
                r.sock = sock
                r.rfile = sock.makefile("rb")
                r.up = True
                gen = r.gen
        except BaseException:
            sock.close()  # a setup error must not leak the fd
            raise
        self._set_up_gauge(r, 1)
        t = threading.Thread(
            target=self._read_loop,
            args=(r, r.rfile, gen),
            name=f"photon-serving-front-read-{r.name}",
            daemon=True,
        )
        self._reader_threads.append(t)
        t.start()
        return True

    def _fail_replica(self, r: _Replica, gen: int) -> List[_Pending]:
        """Tear one replica connection down (idempotent per ``gen``) and
        return the requests that were outstanding on it — the caller owns
        their failover."""
        with r.lock:
            if r.gen != gen:
                return []  # a newer connection already replaced this one
            r.gen += 1
            r.up = False
            victims = list(r.outstanding)
            r.outstanding.clear()
            sock, r.sock, r.rfile = r.sock, None, None
        if sock is not None:
            # shut down before closing: the reader's makefile holds the
            # descriptor open, and only a shutdown ends its blocked read
            # (else close() waits out the join timeout for every reader
            # whose replica is still up)
            for end in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    end()
                except OSError:
                    pass
        self._set_up_gauge(r, 0)
        return victims

    def _read_loop(self, r: _Replica, rfile, gen: int) -> None:
        """Per-connection reader: match responses to outstanding requests
        in order; on EOF/reset, fail the replica and resubmit its
        outstanding requests to the survivors (same trace_id — scoring is
        idempotent, so a request the dead replica *did* score is simply
        scored again)."""
        try:
            while True:
                line = rfile.readline()
                if not line:
                    break
                try:
                    doc = json.loads(line)
                except ValueError:
                    break  # torn mid-line write: the connection is gone
                with r.lock:
                    if r.gen != gen:
                        return
                    pending = r.outstanding.popleft() if r.outstanding else None
                if pending is not None:
                    pending.fut.set_result(doc)
        except (OSError, ValueError):
            pass
        for pending in self._fail_replica(r, gen):
            self._resubmit(pending)

    def _maintain(self) -> None:
        """Reconnect dead replicas + poll /healthz until closed."""
        while not self._closed.wait(self.health_poll_seconds):
            for r in self._replicas:
                if self._closed.is_set():
                    return
                with r.lock:
                    up = r.up
                if not up:
                    self._connect(r)
                if r.healthz is not None:
                    self._poll_healthz(r)

    def _poll_healthz(self, r: _Replica) -> None:
        """A 200 makes the replica routable; 503 (mid-refresh flip or
        overloaded) or an unreachable endpoint drains it — no new
        requests, in-flight ones finish."""
        try:
            with urllib.request.urlopen(
                f"http://{r.healthz}/healthz", timeout=self.connect_timeout
            ):
                healthy = True
        except urllib.error.URLError:
            healthy = False
        except OSError:
            healthy = False
        if healthy != r.healthy:
            r.healthy = healthy
            self._set_up_gauge(r, 1 if (healthy and r.up) else 0)

    # -- routing --------------------------------------------------------------

    def _pick(self, exclude) -> Optional[_Replica]:
        best, best_load = None, None
        for r in self._replicas:
            if r.name in exclude:
                continue
            with r.lock:
                if not r.up or not r.healthy or r.sock is None:
                    continue
                load = len(r.outstanding)
            if best is None or load < best_load:
                best, best_load = r, load
        return best

    def _try_send(self, r: _Replica, pending: _Pending) -> bool:
        ok = True
        with r.lock:
            if not r.up or not r.healthy or r.sock is None:
                return False
            gen = r.gen
            try:
                # the replica-I/O chaos site: an injected io error here is
                # a replica connection dying at send time — the failover
                # drill without killing a process
                faults.check("serving.replica")
                r.outstanding.append(pending)
                r.sock.sendall(pending.payload)
            except OSError:
                ok = False
                if r.outstanding and r.outstanding[-1] is pending:
                    r.outstanding.pop()
        if not ok:
            for victim in self._fail_replica(r, gen):
                self._resubmit(victim)
            return False
        obs.current_run().registry.counter(
            "photon_serving_route_total", _ROUTE_HELP
        ).labels(replica=r.name).inc()
        return True

    def _shed(self, pending: _Pending, reason: str) -> None:
        """A typed refusal WITH a response: the front's no-silent-loss
        contract — every dispatched request resolves, even with the whole
        replica fleet down."""
        obs.current_run().registry.counter(
            "photon_serving_front_sheds_total", _FRONT_SHED_HELP
        ).labels(reason=reason).inc()
        doc = {
            "error": f"front shed ({reason})",
            "error_type": "shed",
            "reason": reason,
            "trace_id": pending.trace_id,
        }
        if pending.model is not None:
            doc["model"] = pending.model
        pending.fut.set_result(doc)

    def _dispatch(self, pending: _Pending) -> None:
        try:
            # the routing chaos site: an injected error at the decision
            # point sheds the request (typed), never drops it
            faults.check("serving.route")
        except OSError:
            self._shed(pending, "route")
            return
        tried: set = set()
        while True:
            if self._closed.is_set():
                self._shed(pending, "front_closed")
                return
            r = self._pick(tried)
            if r is None:
                self._shed(pending, "no_replica")
                return
            if self._try_send(r, pending):
                return
            tried.add(r.name)

    def _resubmit(self, pending: _Pending) -> None:
        if self._closed.is_set():
            self._shed(pending, "front_closed")
            return
        pending.resubmits += 1
        if pending.resubmits > self.max_resubmits:
            self._shed(pending, "resubmit_budget")
            return
        obs.current_run().registry.counter(
            "photon_serving_failover_resubmits_total",
            "in-flight requests resubmitted (same trace_id) after their "
            "replica died mid-request",
        ).inc()
        self._dispatch(pending)

    # -- client surface -------------------------------------------------------

    def submit_doc(self, doc: dict) -> Future:
        """Route one raw JSON request document; the Future resolves to the
        replica's (or the front's own shed) response document. A missing
        ``trace_id`` is assigned here so failover resubmits carry the same
        id end to end."""
        doc = dict(doc)
        if doc.get("trace_id") is None:
            doc["trace_id"] = f"{self._id}.{next(self._req_seq)}"
        fut: Future = Future()
        pending = _Pending(
            (json.dumps(doc) + "\n").encode(),
            fut,
            doc.get("model"),
            str(doc["trace_id"]),
        )
        self._dispatch(pending)
        return fut

    def submit(
        self, request: ScoreRequest, deadline_s: Optional[float] = None
    ) -> Future:
        """ScoringServer-shaped submit: the Future resolves to the float
        score, or raises the typed error the response document carried
        (ShedError / BadRequestError / RuntimeError) — so the open-loop
        harness drives a replica fleet exactly like a single server."""
        doc: Dict[str, object] = {
            "features": {
                s: [list(iv[0]), list(iv[1])]
                for s, iv in request.features.items()
            },
            "ids": dict(request.ids),
            "offset": float(request.offset),
        }
        if request.model is not None:
            doc["model"] = request.model
        if deadline_s is not None:
            doc["deadline_ms"] = float(deadline_s) * 1e3
        out: Future = Future()
        inner = self.submit_doc(doc)

        def _done(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                out.set_exception(exc)
                return
            d = f.result()
            if "score" in d:
                out.set_result(float(d["score"]))
            elif d.get("error_type") == "shed":
                out.set_exception(
                    ShedError(d.get("reason", "unknown"), d.get("error", "shed"))
                )
            elif d.get("error_type") == "bad_request":
                out.set_exception(
                    BadRequestError(
                        d.get("kind", "unknown"), d.get("error", "bad request")
                    )
                )
            else:
                out.set_exception(RuntimeError(d.get("error", "server error")))

        inner.add_done_callback(_done)
        return out

    def score(
        self,
        request: ScoreRequest,
        timeout: Optional[float] = None,
        deadline_s: Optional[float] = None,
    ) -> float:
        """Blocking single-request score through the fleet."""
        return self.submit(request, deadline_s=deadline_s).result(
            timeout=self.request_timeout if timeout is None else timeout
        )

    def replica_states(self) -> Dict[str, dict]:
        """Live routing view per replica (tests + statusz)."""
        out = {}
        for r in self._replicas:
            with r.lock:
                out[r.name] = {
                    "up": r.up,
                    "healthy": r.healthy,
                    "in_flight": len(r.outstanding),
                }
        return out

    def close(self) -> None:
        self._closed.set()
        self._maintainer.join(timeout=5.0)
        for r in self._replicas:
            with r.lock:
                gen = r.gen
            for pending in self._fail_replica(r, gen):
                self._shed(pending, "front_closed")
        for t in self._reader_threads:
            t.join(timeout=5.0)


# -- the front's own socket surface ------------------------------------------


def _front_conn_handler(
    front: LeastLoadedFront, conn: socket.socket, conns, conns_lock
) -> None:
    """Pass-through JSON-lines handler: clients speak the exact replica
    protocol to the front; documents forward verbatim (plus an assigned
    trace_id when the client sent none) and replica responses — model echo,
    shed reasons, bad_request kinds — relay back untouched. Requests on one
    connection forward one at a time, preserving the protocol's in-order
    response guarantee."""
    try:
        with conn, conn.makefile("rwb") as f:

            def respond(doc: dict) -> bool:
                try:
                    f.write((json.dumps(doc) + "\n").encode())
                    f.flush()
                    return True
                except (OSError, ValueError):
                    return False

            while True:
                try:
                    line = f.readline(MAX_REQUEST_LINE_BYTES + 1)
                except (OSError, ValueError):
                    break
                if not line:
                    break
                if len(line) > MAX_REQUEST_LINE_BYTES:
                    _count_bad_request("oversized")
                    respond(
                        {
                            "error": (
                                "request line exceeds "
                                f"{MAX_REQUEST_LINE_BYTES} bytes"
                            ),
                            "error_type": "bad_request",
                            "kind": "oversized",
                        }
                    )
                    break
                if not line.endswith(b"\n"):
                    _count_bad_request("disconnect")
                    break
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError as exc:
                    _count_bad_request("not_json")
                    if not respond(
                        {
                            "error": f"request is not valid JSON: {exc}",
                            "error_type": "bad_request",
                            "kind": "not_json",
                        }
                    ):
                        break
                    continue
                if not isinstance(msg, dict):
                    _count_bad_request("bad_fields")
                    if not respond(
                        {
                            "error": "request must be a JSON object",
                            "error_type": "bad_request",
                            "kind": "bad_fields",
                        }
                    ):
                        break
                    continue
                try:
                    doc = front.submit_doc(msg).result(
                        timeout=front.request_timeout
                    )
                except Exception as exc:
                    obs.swallowed_error("serving.front")
                    doc = {
                        "error": str(exc),
                        "error_type": "error",
                        "trace_id": msg.get("trace_id"),
                    }
                if not respond(doc):
                    break
    except OSError:
        pass  # makefile close flushes into a torn-down socket
    finally:
        with conns_lock:
            conns.discard(conn)


def serve_front_socket(
    front: LeastLoadedFront,
    path: Optional[str] = None,
    stop_event: Optional[threading.Event] = None,
    listen=None,
    on_bound=None,
) -> None:
    """Serve the front over its own AF_UNIX/TCP listener (the replica
    protocol, passed through): ``cli serve --front`` composes this with
    N ``--listen`` replicas to make the fleet one address."""
    from .server import serve_socket

    serve_socket(
        front,
        path=path,
        stop_event=stop_event,
        listen=listen,
        on_bound=on_bound,
        handler=_front_conn_handler,
    )
