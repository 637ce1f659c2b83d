"""The resident scoring service: stores + engines + per-model microbatchers
+ refresh, composed behind one `submit`/`score` surface (the JAX package's
``serving/server.py`` on the port; its JSON-lines protocol byte for byte,
so either package's clients and fronts talk to the other's servers).

The server holds a :class:`~photon_ml_tpu_torch.serving.fleet.ModelSet` — one or
many named resident models, each behind its own bulkhead (see
``serving.fleet``). Requests route by name (``model=`` on the protocol, or
the server's default model); each model keeps exactly one live
``ScoreEngine``: its batcher captures that reference once per microbatch,
and its own ``RefreshWatcher`` flip replaces it with a single attribute
assignment — the GIL makes the swap atomic, the per-batch capture makes it
*clean*: every batch scores entirely on one snapshot, and flips stagger
per model.

Overload protection is the batcher's deadline-budget admission control
(``serving.batcher``): requests carry a latency budget
(``default_deadline_ms`` server-wide, or per request), the pending queue is
bounded, and refusals are typed ``ShedError`` responses counted in
``photon_serving_shed_total{reason=}`` — past the saturation knee the server
sheds excess load instead of letting the queue collapse everyone's p99.

For processes that can't link the package, ``serve_socket`` exposes the same
surface over an AF_UNIX socket (``path=``) or a TCP listener
(``listen="host:port"``) speaking JSON lines through one shared
connection-handler::

    -> {"features": {"shard": [[idx...], [val...]]}, "ids": {...},
        "offset": 0.0, "deadline_ms": 50, "model": "jobs-us"}
    <- {"score": 1.25, "model": "jobs-us", "trace_id": "..."}
     | {"error": "...", "error_type": "shed", "reason": "deadline",
        "model": "jobs-us", "trace_id": "..."}
     | {"error": "...", "error_type": "bad_request", "kind": "not_json",
        "model": "default", "trace_id": "..."}
     | {"error": "...", "error_type": "error", "model": "jobs-us",
        "trace_id": "..."}

one connection per client, one request per line, responses in order.
``model`` is optional on requests (the server's default model otherwise)
and echoed — resolved — on every response shape, so a fleet client can
always attribute a response: the model the request scored (or shed)
against, the requested name verbatim on an ``unknown_model`` refusal, and
the default model's name when the request was too malformed to name one.
A request naming a model the fleet does not hold (or one still warming) is
answered with a typed ``bad_request`` kind=``unknown_model`` — counted,
never silently scored against the default.
Every response carries a ``trace_id`` — success, shed and bad_request
alike — assigned per connection at accept time (or echoed back when the
client sent its own ``"trace_id"`` field); the same id threads through the
batcher's per-stage spans (``serving.admit``/``serving.batch``/
``serving.score``, parented under the request's ``serving.request`` span),
so one slow response is greppable end to end across the trace timeline.
Malformed input never kills the connection silently: oversized lines,
non-JSON, and bad fields each get a typed error (and a
``photon_serving_bad_request_total{kind=}`` count); mid-line disconnects are
counted and closed cleanly. On ``stop_event`` every open connection is shut
down deterministically and its handler thread joined — no daemon thread
outlives the listener holding an open socket.
"""

from __future__ import annotations

import itertools
import json
import numbers
import os
import socket
import threading
from typing import Optional, Tuple, Union

import torch

from .. import obs
from ..device import DeviceLike
from .batcher import RequestTrace, ShedError
from .engine import ScoreEngine, ScoreRequest
from .fleet import ModelSet, UnknownModelError, discover_fleet
from .store import ModelStore

# One JSON-lines request must fit one line; past this the framing cannot be
# trusted, so the response is a typed refusal and the connection closes.
MAX_REQUEST_LINE_BYTES = 1 << 20


class ScoringServer:
    """Resident scorer over published serving roots (or fixed stores/engines).

    With ``serving_root`` the server opens the CURRENT snapshot and watches
    for newly published ones, flipping without dropping requests; with a
    bare ``store``/``engine`` it serves that model until closed. Those
    single-model spellings serve one model named ``default``. The fleet
    spellings hold N models, each behind its own bulkhead and refresh
    watcher (``serving.fleet``): ``models`` maps name -> source (serving
    root path, store dir path, ``ModelStore``, or ``ScoreEngine``);
    ``fleet_root`` discovers one model per subdirectory. Requests route by
    ``model`` (``--models`` name), defaulting to ``default_model`` (the
    first model otherwise). Engines built from stores live on ``device``
    (the card if None)."""

    def __init__(
        self,
        store: Optional[ModelStore] = None,
        engine: Optional[ScoreEngine] = None,
        serving_root: Optional[str] = None,
        models=None,
        fleet_root: Optional[str] = None,
        default_model: Optional[str] = None,
        max_batch: int = 256,
        max_latency_ms: float = 2.0,
        max_pending: int = 1024,
        default_deadline_ms: Optional[float] = None,
        overload_shed_threshold: Optional[float] = None,
        poll_seconds: float = 0.2,
        dtype=torch.float32,
        status_port: Optional[int] = None,
        slow_request_ms: Optional[float] = None,
        per_model=None,
        warm_async: bool = False,
        device: DeviceLike = None,
    ):
        sources = (store, engine, serving_root, models, fleet_root)
        if sum(x is not None for x in sources) != 1:
            raise ValueError(
                "pass exactly one of store / engine / serving_root / "
                "models / fleet_root"
            )
        self.dtype = dtype
        self.default_deadline_s: Optional[float] = (
            None if default_deadline_ms is None else float(default_deadline_ms) / 1e3
        )
        self._status_server = None
        if fleet_root is not None:
            models = discover_fleet(fleet_root)
        if models is None:
            single = store if store is not None else engine
            models = {"default": serving_root if single is None else single}
        self._models = ModelSet(
            models,
            default_model=default_model,
            max_batch=max_batch,
            max_latency_ms=max_latency_ms,
            max_pending=max_pending,
            slow_request_ms=slow_request_ms,
            per_model=per_model,
            poll_seconds=poll_seconds,
            dtype=dtype,
            warm_async=warm_async,
            device=device,
        )
        if overload_shed_threshold is not None:
            # /healthz compares the scrape-delta shed rate against this
            # (obs/http.py): past it the replica answers 503 "overloaded"
            # so a load balancer backs off while scoring itself continues
            obs.current_run().status.update(
                overload_shed_threshold=float(overload_shed_threshold)
            )
        if status_port is not None:
            # live scrape surface (metrics otherwise only flush to files at
            # close): /metrics text exposition, /healthz, /statusz with
            # request QPS + latency quantiles. Bound to the run current at
            # construction — the one the batcher records into.
            self._status_server = obs.IntrospectionServer(
                obs.current_run(), port=status_port
            )
            # advertise the live snapshot on /statusz
            obs.current_run().status.update(
                serving_snapshot=self.snapshot_name
            )

    @property
    def status_port(self) -> Optional[int]:
        """Bound introspection port (useful with ``status_port=0``)."""
        return None if self._status_server is None else self._status_server.port

    # -- fleet surface --------------------------------------------------------

    @property
    def snapshot_name(self) -> Optional[str]:
        """The default model's live snapshot (single-model compatibility)."""
        return self._models.snapshot_names[self._models.default_model]

    @property
    def snapshot_names(self) -> dict:
        """Live snapshot per resident model."""
        return self._models.snapshot_names

    @property
    def model_names(self) -> list:
        return self._models.names

    @property
    def default_model_name(self) -> str:
        return self._models.default_model

    def resolve_model(self, model: Optional[str]) -> str:
        """Resolved model name for a requested one (None -> default);
        raises :class:`~photon_ml_tpu_torch.serving.fleet.UnknownModelError` for
        names this fleet does not hold or has not finished warming."""
        return self._models.resolve(model)

    def poke_refresh(self, model: Optional[str] = None) -> None:
        """Force an immediate CURRENT check on one model's watcher, or all
        of them (tests; avoids poll sleeps)."""
        self._models.poke_refresh(model)

    # -- scoring surface ------------------------------------------------------

    def submit(
        self,
        request: ScoreRequest,
        deadline_s: Optional[float] = None,
        trace: Optional[RequestTrace] = None,
        model: Optional[str] = None,
    ):
        """Enqueue one request; returns a Future resolving to its score.
        ``deadline_s`` overrides the server's ``default_deadline_ms`` budget
        for this request (None = use the server default; the admission
        controller may raise :class:`ShedError` immediately). ``model``
        (explicit arg, else ``request.model``) routes to that model's
        bulkhead. ``trace`` threads a request-scoped trace context
        (trace_id + root span) through the batcher's per-stage spans."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        return self._models.submit(
            request, deadline_s=deadline_s, trace=trace, model=model
        )

    def score(
        self,
        request: ScoreRequest,
        timeout: float = 30.0,
        deadline_s: Optional[float] = None,
        trace: Optional[RequestTrace] = None,
        model: Optional[str] = None,
    ) -> float:
        """Blocking single-request score (sheds surface as ShedError)."""
        return self.submit(
            request, deadline_s=deadline_s, trace=trace, model=model
        ).result(timeout=timeout)

    def queue_stats(self, model: Optional[str] = None) -> dict:
        """Live admission-queue stats (pending depth + drain estimate):
        one model's by name, or the fleet aggregate on a multi-model set."""
        return self._models.queue_stats(model)

    def close(self) -> None:
        if self._status_server is not None:
            self._status_server.stop()
        self._models.close()


# -- the socket front --------------------------------------------------------


class BadRequestError(ValueError):
    """A socket request the server refuses to parse; ``kind`` is the
    ``photon_serving_bad_request_total`` label."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


def _count_bad_request(kind: str) -> None:
    obs.current_run().registry.counter(
        "photon_serving_bad_request_total",
        "malformed socket requests refused with a typed error",
    ).labels(kind=kind).inc()


def _parse_score_request(msg) -> Tuple[ScoreRequest, Optional[float]]:
    """Validate one decoded JSON request; raises BadRequestError('bad_fields')
    on anything the engine should never see. Returns (request, deadline_s)."""
    if not isinstance(msg, dict):
        raise BadRequestError(
            "bad_fields", f"request must be a JSON object, got {type(msg).__name__}"
        )
    if "features" not in msg:
        raise BadRequestError("bad_fields", "missing required field 'features'")
    features = msg["features"]
    if not isinstance(features, dict):
        raise BadRequestError(
            "bad_fields",
            f"'features' must map shard -> [[idx...], [val...]], "
            f"got {type(features).__name__}",
        )
    parsed = {}
    for shard, iv in features.items():
        if (
            not isinstance(iv, (list, tuple))
            or len(iv) != 2
            or not all(isinstance(x, (list, tuple)) for x in iv)
            or len(iv[0]) != len(iv[1])
        ):
            raise BadRequestError(
                "bad_fields",
                f"features[{shard!r}] must be two equal-length lists "
                "[[idx...], [val...]]",
            )
        idx, val = iv
        if not all(isinstance(i, int) and not isinstance(i, bool) and i >= 0 for i in idx):
            raise BadRequestError(
                "bad_fields", f"features[{shard!r}] indices must be ints >= 0"
            )
        if not all(
            isinstance(v, numbers.Real) and not isinstance(v, bool) for v in val
        ):
            raise BadRequestError(
                "bad_fields", f"features[{shard!r}] values must be numbers"
            )
        parsed[shard] = (tuple(int(i) for i in idx), tuple(float(v) for v in val))
    ids = msg.get("ids", {})
    if not isinstance(ids, dict):
        raise BadRequestError("bad_fields", "'ids' must be a JSON object")
    offset = msg.get("offset", 0.0)
    if not isinstance(offset, numbers.Real) or isinstance(offset, bool):
        raise BadRequestError("bad_fields", "'offset' must be a number")
    model = msg.get("model")
    if model is not None and not isinstance(model, str):
        raise BadRequestError(
            "bad_fields", "'model' must be a string (a resident model name)"
        )
    deadline_ms = msg.get("deadline_ms")
    deadline_s: Optional[float] = None
    if deadline_ms is not None:
        if not isinstance(deadline_ms, numbers.Real) or isinstance(deadline_ms, bool):
            raise BadRequestError("bad_fields", "'deadline_ms' must be a number")
        if float(deadline_ms) <= 0:
            raise BadRequestError("bad_fields", "'deadline_ms' must be > 0")
        deadline_s = float(deadline_ms) / 1e3
    return (
        ScoreRequest(features=parsed, ids=ids, offset=float(offset), model=model),
        deadline_s,
    )


# connection sequence for trace_id assignment: ids are unique per process
# (pid prefix) and per accepted connection, so a fleet-merged trace stream
# never collides request ids across replicas
_conn_ids = itertools.count(1)


def _requested_model(msg, server: ScoringServer) -> str:
    """Best-effort model echo for refused requests: the name the request
    asked for when it managed to say one, else the default model (the one
    it would have scored against)."""
    if isinstance(msg, dict) and isinstance(msg.get("model"), str):
        return msg["model"]
    return server.default_model_name


def _handle_conn(server: ScoringServer, conn: socket.socket, conns, conns_lock) -> None:
    """One JSON-lines connection: the shared handler behind both the AF_UNIX
    and the TCP listener. Registered in ``conns`` so the listener can shut
    the connection down deterministically at stop time. Every request gets
    a ``trace_id`` (``<pid>-<conn>.<seq>``, or the client's own) echoed on
    every response shape, and every response echoes the resolved ``model``."""
    conn_id = f"{os.getpid():x}-{next(_conn_ids)}"
    req_seq = itertools.count(1)
    try:
        with conn, conn.makefile("rwb") as f:

            def respond(doc: dict) -> bool:
                try:
                    f.write((json.dumps(doc) + "\n").encode())
                    f.flush()
                    return True
                except (OSError, ValueError):
                    return False  # peer (or the stop path) tore the socket down

            while True:
                try:
                    line = f.readline(MAX_REQUEST_LINE_BYTES + 1)
                except (OSError, ValueError):
                    break  # shutdown() from the stop path, or peer reset
                if not line:
                    break  # clean EOF
                trace_id = f"{conn_id}.{next(req_seq)}"
                if len(line) > MAX_REQUEST_LINE_BYTES:
                    # framing is unrecoverable past the cap: typed refusal,
                    # then a deterministic close
                    _count_bad_request("oversized")
                    respond(
                        {
                            "error": (
                                "request line exceeds "
                                f"{MAX_REQUEST_LINE_BYTES} bytes"
                            ),
                            "error_type": "bad_request",
                            "kind": "oversized",
                            "model": server.default_model_name,
                            "trace_id": trace_id,
                        }
                    )
                    break
                if not line.endswith(b"\n"):
                    # mid-line disconnect: nothing to respond to, close clean
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
                            "model": server.default_model_name,
                            "trace_id": trace_id,
                        }
                    ):
                        break
                    continue
                if isinstance(msg, dict) and msg.get("trace_id") is not None:
                    # client-supplied correlation id: echoed and threaded
                    # through the stage spans in place of the assigned one
                    trace_id = str(msg["trace_id"])
                with obs.span("serving.request", trace_id=trace_id) as root:
                    try:
                        req, deadline_s = _parse_score_request(msg)
                        # resolve BEFORE queueing: an unknown (or still
                        # warming) model is a typed refusal, never scored
                        # against the default and never owed a queue slot
                        resolved = server.resolve_model(req.model)
                    except BadRequestError as exc:
                        _count_bad_request(exc.kind)
                        root.attrs["outcome"] = "bad_request"
                        out = {
                            "error": str(exc),
                            "error_type": "bad_request",
                            "kind": exc.kind,
                            "model": _requested_model(msg, server),
                            "trace_id": trace_id,
                        }
                    except UnknownModelError as exc:
                        _count_bad_request(exc.kind)
                        root.attrs["outcome"] = "bad_request"
                        out = {
                            "error": str(exc),
                            "error_type": "bad_request",
                            "kind": exc.kind,
                            "model": _requested_model(msg, server),
                            "trace_id": trace_id,
                        }
                    else:
                        root.attrs["model"] = resolved
                        trace = RequestTrace(trace_id=trace_id, parent=root)
                        try:
                            out = {
                                "score": server.score(
                                    req, deadline_s=deadline_s, trace=trace
                                ),
                                "model": resolved,
                                "trace_id": trace_id,
                            }
                            root.attrs["outcome"] = "ok"
                        except ShedError as exc:
                            # admission refusal: a typed response, never a
                            # dropped connection — the client can back off
                            # and retry
                            root.attrs["outcome"] = "shed"
                            out = {
                                "error": str(exc),
                                "error_type": "shed",
                                "reason": exc.reason,
                                "model": resolved,
                                "trace_id": trace_id,
                            }
                        except Exception as exc:
                            obs.swallowed_error("serving.socket")
                            root.attrs["outcome"] = "error"
                            out = {
                                "error": str(exc),
                                "error_type": "error",
                                "model": resolved,
                                "trace_id": trace_id,
                            }
                if not respond(out):
                    break
    except OSError:
        pass  # makefile close flushes into a torn-down socket (replica kill)
    finally:
        with conns_lock:
            conns.discard(conn)


def _parse_listen(listen: Union[str, Tuple[str, int]]) -> Tuple[str, int]:
    if isinstance(listen, (tuple, list)) and len(listen) == 2:
        return str(listen[0]), int(listen[1])
    host, sep, port = str(listen).rpartition(":")
    if not sep or not host:
        raise ValueError(
            f"--listen address must be host:port, got {listen!r}"
        )
    return host, int(port)


def serve_socket(
    server,
    path: Optional[str] = None,
    stop_event: Optional[threading.Event] = None,
    listen: Optional[Union[str, Tuple[str, int]]] = None,
    on_bound=None,
    handler=None,
) -> None:
    """Serve ``server`` over exactly one of an AF_UNIX socket at ``path`` or
    a TCP listener at ``listen`` ("host:port" or (host, port); port 0 binds
    ephemeral) until ``stop_event`` is set (runs forever without one). One
    thread per connection through the shared JSON-lines handler —
    ``handler`` swaps it out (same ``(server, conn, conns, conns_lock)``
    signature; the replica front's pass-through handler reuses this whole
    accept/shutdown loop over its own routing surface). ``on_bound`` (if
    given) is called once with the bound address — the socket path, or the
    (host, port) tuple with the resolved port.

    Shutdown is deterministic: when ``stop_event`` fires, every open
    connection is shut down (interrupting blocked reads) and every handler
    thread joined before this function returns — no daemon thread survives
    holding an open socket."""
    if (path is None) == (listen is None):
        raise ValueError(
            "serve_socket needs exactly one of path (AF_UNIX) / listen (TCP "
            "host:port)"
        )
    stop = stop_event or threading.Event()
    handler = handler or _handle_conn
    conns: set = set()
    conns_lock = threading.Lock()
    threads = []
    if path is not None:
        if os.path.exists(path):
            os.unlink(path)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.bind(path)
        except BaseException:
            sock.close()  # a bind error must not leak the fd
            raise
        bound: object = path
    else:
        host, port = _parse_listen(listen)
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, port))
            bound = sock.getsockname()[:2]
        except BaseException:
            sock.close()  # a bind error must not leak the fd
            raise
    try:
        with sock:
            sock.listen()
            sock.settimeout(0.2)
            if on_bound is not None:
                on_bound(bound)
            while not stop.is_set():
                try:
                    conn, _ = sock.accept()
                except socket.timeout:
                    continue
                with conns_lock:
                    conns.add(conn)
                t = threading.Thread(
                    target=handler,
                    args=(server, conn, conns, conns_lock),
                    daemon=True,
                )
                threads.append(t)
                t.start()
                if len(threads) > 64:
                    threads = [x for x in threads if x.is_alive()]
    finally:
        with conns_lock:
            live = list(conns)
        for c in live:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # already closed by its handler
        for t in threads:
            t.join(timeout=5.0)
        if path is not None and os.path.exists(path):
            os.unlink(path)
