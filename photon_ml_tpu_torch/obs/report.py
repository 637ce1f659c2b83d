"""Post-hoc run reports: assemble training artifacts into report.json + a
self-contained single-file HTML report.

The reference's photon-client renders per-model HTML training reports
(Diagnostics + model summaries) next to every fit; this module is that
subsystem, the JAX package's ``obs/report.py`` on the port, copied: the
same artifacts give the same report.json and report.html in both packages,
whichever package wrote them. Inputs are EXISTING artifacts only —
run_summary.json, metrics.jsonl, training-summary.json, saved model dirs,
partitioned feature-index metadata, boundary-checkpoint manifests, and
bench --progress-out JSONL — so the same report rebuilds bit-identically
after the fact: ``cli train --report-out`` and ``cli report <artifacts-dir>``
both run :func:`discover` + :func:`build_report` over the same files.

It touches no card: model avro files are read through ``io.avro``
directly (coefficients serialize as (name, term, value) triples, so feature
names need no index decode), and the HTML is stdlib string assembly with
inline SVG sparklines — no matplotlib, runnable on a host with no
accelerator runtime.
"""

from __future__ import annotations

import dataclasses
import html as _html
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..robust.atomic import atomic_write, atomic_write_json
from . import diagnostics
from .memory import memory_block

# v2: added the top-level "plan" key (the resolved execution plan from
# run_summary.json; None for runs that predate the planner)
# v3: added the top-level "flight" key (flight-recorder postmortem index;
# empty for runs with no anomaly dumps)
REPORT_SCHEMA_VERSION = 3
REPORT_JSON = "report.json"
REPORT_HTML = "report.html"

# files the discovery walk recognizes by name
_RUN_SUMMARY = "run_summary.json"
_TRAINING_SUMMARY = "training-summary.json"
_METRICS_JSONL = "metrics.jsonl"
_MODEL_METADATA = "model-metadata.json"
_CKPT_MANIFEST = "MANIFEST.json"


@dataclasses.dataclass
class ReportInputs:
    """Everything :func:`build_report` reads, already loaded from disk."""

    run_summary: Optional[dict] = None
    training_summary: Optional[dict] = None
    # one entry per metrics-flush line of metrics.jsonl, in file order
    metric_snapshots: List[List[dict]] = dataclasses.field(default_factory=list)
    # display name -> model directory (holds model-metadata.json)
    model_dirs: Dict[str, str] = dataclasses.field(default_factory=dict)
    # feature shard -> total feature count (from _index-<shard>-meta.json)
    feature_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    checkpoint_manifests: List[dict] = dataclasses.field(default_factory=list)
    bench_progress: List[dict] = dataclasses.field(default_factory=list)
    # flight-recorder postmortems (flight-<kind>-<seq>.json), root-relative
    # "path" attached so the report links back to the full dump
    flight_dumps: List[dict] = dataclasses.field(default_factory=list)


def _load_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_metric_snapshots(path: str) -> List[List[dict]]:
    try:
        with open(path, encoding="utf-8") as f:
            return list(diagnostics.iter_metric_snapshots(f))
    except OSError:
        return []


def _load_bench_progress(path: str) -> List[dict]:
    """bench_diff rows of a --progress-out JSONL file (other row types in
    the same file are the driver's own and are skipped)."""
    rows: List[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict) and row.get("type") == "bench_diff":
                    rows.append(row)
    except OSError:
        pass
    return rows


def discover(root: str) -> ReportInputs:
    """Walk ``root`` for every artifact the report understands. Model dirs
    are named by basename (their save name, e.g. ``best`` / ``model-0``),
    falling back to the root-relative path on collision. A previous report
    output inside ``root`` is ignored so rebuilds are stable."""
    inputs = ReportInputs()
    model_paths: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fname in sorted(filenames):
            path = os.path.join(dirpath, fname)
            if fname == _RUN_SUMMARY and inputs.run_summary is None:
                inputs.run_summary = _load_json(path)
            elif fname == _TRAINING_SUMMARY and inputs.training_summary is None:
                inputs.training_summary = _load_json(path)
            elif fname == _METRICS_JSONL and not inputs.metric_snapshots:
                inputs.metric_snapshots = load_metric_snapshots(path)
            elif fname == _MODEL_METADATA:
                model_paths.append(dirpath)
            elif fname == _CKPT_MANIFEST:
                doc = _load_json(path)
                if doc is not None:
                    inputs.checkpoint_manifests.append(doc)
            elif fname.startswith("_index-") and fname.endswith("-meta.json"):
                doc = _load_json(path)
                if doc and "shard" in doc and "size" in doc:
                    inputs.feature_counts[str(doc["shard"])] = int(doc["size"])
            elif fname.startswith("flight-") and fname.endswith(".json"):
                doc = _load_json(path)
                if doc and "trigger" in doc:
                    doc["path"] = os.path.relpath(path, root)
                    inputs.flight_dumps.append(doc)
            elif fname.endswith(".jsonl") and fname != _METRICS_JSONL:
                rows = _load_bench_progress(path)
                if rows:
                    inputs.bench_progress.extend(rows)
    basenames = [os.path.basename(p.rstrip("/")) for p in model_paths]
    for path, base in zip(model_paths, basenames):
        name = base
        if basenames.count(base) > 1 or name in inputs.model_dirs:
            name = os.path.relpath(path, root)
        inputs.model_dirs[name] = path
    inputs.checkpoint_manifests.sort(key=lambda m: int(m.get("step", 0)))
    inputs.flight_dumps.sort(
        key=lambda d: (float((d.get("trigger") or {}).get("unix_time") or 0.0),
                       d.get("path", ""))
    )
    return inputs


def collect_training_inputs(
    summary_dir: Optional[str] = None,
    output_dir: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    feature_index_dir: Optional[str] = None,
) -> ReportInputs:
    """ReportInputs from the layout ``cli train`` writes, loading the same
    files :func:`discover` would find by walking — the train-time report and
    a later ``cli report`` rebuild therefore read identical bytes."""
    inputs = ReportInputs()
    if summary_dir:
        inputs.run_summary = _load_json(os.path.join(summary_dir, _RUN_SUMMARY))
        inputs.metric_snapshots = load_metric_snapshots(
            os.path.join(summary_dir, _METRICS_JSONL)
        )
    if output_dir:
        inputs.training_summary = _load_json(
            os.path.join(output_dir, _TRAINING_SUMMARY)
        )
        models_root = os.path.join(output_dir, "models")
        if os.path.isdir(models_root):
            for name in sorted(os.listdir(models_root)):
                path = os.path.join(models_root, name)
                if os.path.isfile(os.path.join(path, _MODEL_METADATA)):
                    inputs.model_dirs[name] = path
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        for dirpath, dirnames, filenames in os.walk(checkpoint_dir):
            dirnames.sort()
            if _CKPT_MANIFEST in filenames:
                doc = _load_json(os.path.join(dirpath, _CKPT_MANIFEST))
                if doc is not None:
                    inputs.checkpoint_manifests.append(doc)
        inputs.checkpoint_manifests.sort(key=lambda m: int(m.get("step", 0)))
    if feature_index_dir and os.path.isdir(feature_index_dir):
        for fname in sorted(os.listdir(feature_index_dir)):
            if fname.startswith("_index-") and fname.endswith("-meta.json"):
                doc = _load_json(os.path.join(feature_index_dir, fname))
                if doc and "shard" in doc and "size" in doc:
                    inputs.feature_counts[str(doc["shard"])] = int(doc["size"])
    return inputs


# ---------------------------------------------------------------------------
# saved-model reading (avro triples -> diagnostics)


def _feature_display(name: str, term: str) -> str:
    return f"{name}:{term}" if term else name


def _iter_model_records(coeff_dir: str):
    from ..io.avro import read_avro_file

    for fname in sorted(os.listdir(coeff_dir)):
        if not fname.endswith(".avro"):
            continue
        _, records = read_avro_file(os.path.join(coeff_dir, fname))
        yield from records


def _fixed_effect_diagnostics(base: str, feature_counts: Dict[str, int], top_k: int) -> dict:
    shard = _read_id_info(base)[0]
    values: List[float] = []
    names: List[str] = []
    for rec in _iter_model_records(os.path.join(base, "coefficients")):
        for triple in rec.get("means") or []:
            values.append(float(triple["value"]))
            names.append(
                _feature_display(triple.get("name") or "", triple.get("term") or "")
            )
    out = {
        "type": "fixed",
        "feature_shard": shard,
        "coefficients": diagnostics.coefficient_summary(
            values, names, feature_counts.get(shard), top_k=top_k
        ),
    }
    return out


def _random_effect_diagnostics(base: str, feature_counts: Dict[str, int], top_k: int) -> dict:
    info = _read_id_info(base)
    re_type = info[0]
    shard = info[1] if len(info) > 1 else ""
    values: List[float] = []
    norms: List[float] = []
    counts: List[int] = []
    for rec in _iter_model_records(os.path.join(base, "coefficients")):
        means = [float(t["value"]) for t in rec.get("means") or []]
        values.extend(means)
        a = np.asarray(means, dtype=np.float64)
        norms.append(float(np.sqrt((a * a).sum())))
        counts.append(int(np.count_nonzero(a)))
    return {
        "type": "random",
        "feature_shard": shard,
        "random_effect_type": re_type,
        "n_entities": len(norms),
        # pooled across entities: the overall weight distribution this
        # random effect adds on top of the fixed effect
        "coefficients": diagnostics.coefficient_summary(
            values, None, feature_counts.get(shard), top_k=top_k
        ),
        "shrinkage": diagnostics.shrinkage_summary(norms, counts),
    }


def _read_id_info(base: str) -> List[str]:
    try:
        with open(os.path.join(base, "id-info"), encoding="utf-8") as f:
            return [ln.strip() for ln in f if ln.strip()]
    except OSError:
        return [""]


def model_diagnostics(
    model_dir: str, feature_counts: Dict[str, int], top_k: int = 20
) -> dict:
    """Per-coordinate diagnostics for one saved GAME model directory
    (io/model_io.py layout), read through the avro codec only."""
    coordinates: Dict[str, dict] = {}
    fe_root = os.path.join(model_dir, "fixed-effect")
    if os.path.isdir(fe_root):
        for name in sorted(os.listdir(fe_root)):
            base = os.path.join(fe_root, name)
            if os.path.isdir(base):
                coordinates[name] = _fixed_effect_diagnostics(
                    base, feature_counts, top_k
                )
    re_root = os.path.join(model_dir, "random-effect")
    if os.path.isdir(re_root):
        for name in sorted(os.listdir(re_root)):
            base = os.path.join(re_root, name)
            if os.path.isdir(base):
                coordinates[name] = _random_effect_diagnostics(
                    base, feature_counts, top_k
                )
    meta = _load_json(os.path.join(model_dir, _MODEL_METADATA)) or {}
    return {"metadata": meta, "coordinates": coordinates}


# ---------------------------------------------------------------------------
# report assembly


def _compile_seconds(snapshot: Sequence[dict]) -> Optional[float]:
    """Total XLA compile seconds: sum of the photon_jax_compile_seconds
    summary family across jax event names. Only the JAX package records
    that family; the port builds its kernels once, outside the run, so a
    port run's report carries None here."""
    total = 0.0
    seen = False
    for m in snapshot:
        if m.get("name") == "photon_jax_compile_seconds" and "sum" in m:
            total += float(m["sum"])
            seen = True
    return total if seen else None


def _streaming_utilization(snapshot: Sequence[dict]) -> Dict[str, dict]:
    """Per-site streamed-slice utilization from the final metrics snapshot:
    slices/bytes staged, configured budget vs actual peak slice, headroom."""
    sites: Dict[str, dict] = {}
    keymap = {
        "photon_stream_slices_total": "slices_staged",
        "photon_stream_staged_bytes_total": "staged_bytes",
        "photon_stream_budget_bytes": "budget_bytes",
        "photon_stream_actual_slice_bytes": "actual_slice_bytes",
        "photon_stream_budget_headroom_bytes": "budget_headroom_bytes",
        "photon_stream_stage_seconds": "stage_seconds",
        "photon_stream_solve_seconds": "solve_seconds",
    }
    for m in snapshot:
        key = keymap.get(m.get("name"))
        if key is None or "value" not in m:
            continue
        site = str(m.get("labels", {}).get("site", ""))
        sites.setdefault(site, {})[key] = float(m["value"])
    for info in sites.values():
        budget = info.get("budget_bytes")
        actual = info.get("actual_slice_bytes")
        if budget and actual is not None:
            # 2x: the double buffer holds two slices at peak
            info["budget_utilization"] = 2.0 * actual / budget
    return sites


def build_report(inputs: ReportInputs, top_k: int = 20) -> dict:
    """Assemble the full report document. Deterministic by construction —
    no generation-time timestamps — so rebuilding from the same artifacts
    yields an identical report.json (the rebuild-identity guarantee)."""
    rs = inputs.run_summary or {}
    ts = inputs.training_summary or {}
    final_snapshot = rs.get("metrics") or []
    snapshots = inputs.metric_snapshots

    models = {
        name: model_diagnostics(path, inputs.feature_counts, top_k=top_k)
        for name, path in sorted(inputs.model_dirs.items())
    }

    coordinates: Dict[str, dict] = {}
    for coord, info in (rs.get("coordinates") or {}).items():
        coordinates[coord] = dict(info)
    loss_traj = diagnostics.gauge_trajectories(
        snapshots, "photon_cd_accepted_loss", "coordinate"
    )
    iter_traj = diagnostics.gauge_trajectories(
        snapshots, "photon_cd_update_iterations", "coordinate"
    )
    for coord, series in loss_traj.items():
        coordinates.setdefault(coord, {})["accepted_loss_trajectory"] = series
    for coord, series in iter_traj.items():
        coordinates.setdefault(coord, {})["iterations_trajectory"] = series
    for m in final_snapshot:
        if m.get("name") == "photon_cd_final_loss":
            coord = str(m.get("labels", {}).get("coordinate", ""))
            coordinates.setdefault(coord, {})["final_loss"] = float(m["value"])

    convergence = {
        "coordinates": coordinates,
        "validation_trajectories": diagnostics.validation_trajectories(snapshots),
        "n_metric_flushes": len(snapshots),
    }

    timeline = rs.get("timeline")
    performance: dict = {
        "total_wall_seconds": rs.get("total_wall_seconds"),
        "aborted": bool(rs.get("aborted", False)),
        "compile_seconds": _compile_seconds(final_snapshot),
        "timeline": None,
        "streaming": _streaming_utilization(final_snapshot),
    }
    if timeline:
        total = timeline.get("total") or {}
        performance["timeline"] = {
            "n_sweeps": timeline.get("n_sweeps"),
            "total": total,
            "overlap_factor_per_sweep": [
                s.get("overlap_factor") for s in timeline.get("sweeps") or []
            ],
        }

    memory = rs.get("memory") or memory_block(final_snapshot)

    report = {
        "schema_version": REPORT_SCHEMA_VERSION,
        "task": rs.get("task") or ts.get("task"),
        "best": rs.get("best") or ts.get("best"),
        "models": models,
        "convergence": convergence,
        "performance": performance,
        "plan": rs.get("plan"),
        "memory": memory,
        "checkpoints": [
            {
                "step": m.get("step"),
                "iteration": m.get("iteration"),
                "coordinate": m.get("coordinate"),
                "bytes": m.get("bytes"),
            }
            for m in inputs.checkpoint_manifests
        ],
        "bench": {"progress": inputs.bench_progress},
        "flight": [
            {
                "trigger": (d.get("trigger") or {}).get("kind"),
                "detail": (d.get("trigger") or {}).get("detail"),
                "unix_time": (d.get("trigger") or {}).get("unix_time"),
                "process_index": (d.get("identity") or {}).get("process_index"),
                "replica": (d.get("identity") or {}).get("replica"),
                "n_events": len(d.get("events") or []),
                "path": d.get("path"),
            }
            for d in inputs.flight_dumps
        ],
    }
    return report


def bench_diff(old: dict, new: dict) -> Dict[str, dict]:
    """Per-series deltas between two BENCH json records (the report-side
    subset of ``bench.py --diff``: shared numeric quadrant keys only)."""
    out: Dict[str, dict] = {}
    oq, nq = old.get("quadrants") or {}, new.get("quadrants") or {}
    for side in sorted(set(oq) & set(nq)):
        os_, ns_ = oq[side] or {}, nq[side] or {}
        for key in sorted(set(os_) & set(ns_)):
            o_v, n_v = os_[key], ns_[key]
            if isinstance(o_v, (int, float)) and isinstance(n_v, (int, float)):
                delta = (float(n_v) - float(o_v)) / float(o_v) if o_v else 0.0
                out[f"quadrants.{side}.{key}"] = {
                    "old": float(o_v),
                    "new": float(n_v),
                    "delta_pct": 100.0 * delta,
                }
    return out


# ---------------------------------------------------------------------------
# HTML rendering (stdlib only; inline SVG sparklines)


def sparkline_svg(
    values: Sequence[Optional[float]], width: int = 260, height: int = 40
) -> str:
    """Inline SVG polyline over ``values``; None entries are gaps. Returns a
    placeholder box when fewer than two finite points exist."""
    pts = [
        (i, float(v))
        for i, v in enumerate(values)
        if v is not None and np.isfinite(v)
    ]
    if len(pts) < 2:
        return (
            f'<svg width="{width}" height="{height}" class="spark">'
            f'<text x="4" y="{height - 6}" class="sparktext">n/a</text></svg>'
        )
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    lo, hi = min(ys), max(ys)
    span = (hi - lo) or 1.0
    x0, x1 = min(xs), max(xs)
    xspan = (x1 - x0) or 1
    pad = 3
    coords = " ".join(
        f"{pad + (x - x0) / xspan * (width - 2 * pad):.1f},"
        f"{height - pad - (y - lo) / span * (height - 2 * pad):.1f}"
        for x, y in pts
    )
    return (
        f'<svg width="{width}" height="{height}" class="spark">'
        f'<polyline fill="none" stroke="#36c" stroke-width="1.5" '
        f'points="{coords}"/>'
        f'<title>min {lo:.6g} · max {hi:.6g}</title></svg>'
    )


def _esc(v) -> str:
    return _html.escape(str(v))


def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.6g}"
    return _esc(v)


def _bytes_h(v) -> str:
    if v is None:
        return "—"
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024 or unit == "TiB":
            return f"{v:.1f} {unit}"
        v /= 1024
    return f"{v:.1f} TiB"


def _table(headers: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    head = "".join(f"<th>{_esc(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>" for row in rows
    )
    return f"<table><thead><tr>{head}</tr></thead><tbody>{body}</tbody></table>"


_CSS = """
body { font: 14px/1.45 system-ui, sans-serif; margin: 2em auto; max-width: 72em;
       color: #222; padding: 0 1em; }
h1 { font-size: 1.5em; } h2 { font-size: 1.2em; margin-top: 2em;
     border-bottom: 1px solid #ddd; padding-bottom: .2em; }
h3 { font-size: 1em; margin-bottom: .3em; }
table { border-collapse: collapse; margin: .5em 0 1.2em; }
th, td { border: 1px solid #ddd; padding: .25em .6em; text-align: right; }
th:first-child, td:first-child { text-align: left; }
thead th { background: #f5f5f7; }
.spark { vertical-align: middle; background: #fafafa; border: 1px solid #eee; }
.sparktext { font-size: 11px; fill: #999; }
.kv span { display: inline-block; margin-right: 2em; color: #555; }
.kv b { color: #111; }
.aborted { color: #b00; font-weight: bold; }
"""


def render_html(report: dict) -> str:
    """Self-contained single-file HTML view of a report document."""
    parts: List[str] = []
    task = report.get("task")
    parts.append(f"<h1>photon-ml-tpu training report</h1>")
    kv = [f"<span>task <b>{_esc(task)}</b></span>" if task else ""]
    best = report.get("best") or {}
    if best.get("metrics"):
        kv.append(
            "<span>best "
            + " · ".join(
                f"{_esc(k)} <b>{_fmt(v)}</b>" for k, v in best["metrics"].items()
            )
            + "</span>"
        )
    perf = report.get("performance") or {}
    if perf.get("total_wall_seconds") is not None:
        kv.append(
            f"<span>wall <b>{_fmt(perf['total_wall_seconds'])} s</b></span>"
        )
    if perf.get("aborted"):
        kv.append('<span class="aborted">run aborted mid-sweep</span>')
    parts.append(f'<p class="kv">{"".join(kv)}</p>')

    # -- execution plan ----------------------------------------------------
    plan = report.get("plan") or {}
    if plan.get("coordinates"):
        parts.append("<h2>Execution plan</h2>")
        mesh = plan.get("mesh_axes") or {}
        topo = [
            f"<span>processes <b>{_fmt(plan.get('n_processes'))}</b></span>",
            "<span>mesh <b>"
            + (_esc(" ".join(f"{k}={v}" for k, v in mesh.items()))
               if mesh else "none (single device)")
            + "</b></span>",
            f"<span>pipeline depth <b>{_fmt(plan.get('pipeline_depth'))}</b></span>",
            f"<span>trial lanes <b>{_fmt(plan.get('trial_lanes'))}</b></span>",
        ]
        parts.append(f'<p class="kv">{"".join(topo)}</p>')
        rows = [
            [
                _esc(c.get("name")),
                _esc(c.get("kind")),
                _esc(c.get("layout")),
                _fmt(c.get("feature_dtype")),
                _esc(c.get("residency")),
                _esc(c.get("sharding")),
                "yes" if c.get("pipelined") else "no",
            ]
            for c in plan["coordinates"]
        ]
        parts.append(
            _table(
                ["coordinate", "kind", "layout", "dtype", "residency",
                 "routing", "pipelined"],
                rows,
            )
        )

    # -- memory ------------------------------------------------------------
    memory = report.get("memory") or {}
    if memory:
        parts.append("<h2>Memory</h2>")
        rows = []
        host = memory.get("host") or {}
        if host:
            rows.append(
                ["host RSS", _bytes_h(host.get("rss_bytes")),
                 _bytes_h(host.get("peak_rss_bytes"))]
            )
        for dev, st in sorted((memory.get("devices") or {}).items()):
            rows.append(
                [f"device {dev} HBM", _bytes_h(st.get("bytes_in_use")),
                 _bytes_h(st.get("peak_bytes_in_use"))
                 + (f" / {_bytes_h(st['bytes_limit'])} limit"
                    if st.get("bytes_limit") else "")]
            )
        if rows:
            parts.append(_table(["", "last sample", "high-water"], rows))
        streaming = memory.get("streaming") or {}
        if streaming:
            parts.append(
                _table(
                    ["site", "hbm budget", "headroom"],
                    [
                        [_esc(site), _bytes_h(b.get("hbm_budget_bytes")),
                         _bytes_h(b.get("hbm_budget_headroom_bytes"))]
                        for site, b in sorted(streaming.items())
                    ],
                )
            )

    # -- convergence -------------------------------------------------------
    conv = report.get("convergence") or {}
    coords = conv.get("coordinates") or {}
    if coords:
        parts.append("<h2>Convergence</h2>")
        rows = []
        for name, info in sorted(coords.items()):
            it = info.get("iterations") or {}
            reasons = info.get("convergence_reasons") or {}
            rows.append(
                [
                    _esc(name),
                    sparkline_svg(info.get("accepted_loss_trajectory") or []),
                    _fmt(info.get("final_loss")),
                    _fmt(it.get("count")),
                    _fmt(it.get("mean")),
                    _fmt(info.get("rejections", 0)),
                    _esc(", ".join(f"{k}×{v}" for k, v in sorted(reasons.items()))),
                ]
            )
        parts.append(
            _table(
                ["coordinate", "accepted loss / sweep", "final loss",
                 "updates", "mean solver iters", "rejections", "reasons"],
                rows,
            )
        )
    val = conv.get("validation_trajectories") or {}
    if val:
        parts.append("<h3>Validation metrics</h3>")
        parts.append(
            _table(
                ["metric", "trajectory", "last"],
                [
                    [_esc(k), sparkline_svg(series),
                     _fmt(next((v for v in reversed(series) if v is not None), None))]
                    for k, series in sorted(val.items())
                ],
            )
        )

    # -- models ------------------------------------------------------------
    models = report.get("models") or {}
    if models:
        parts.append("<h2>Models</h2>")
    for mname, mdoc in sorted(models.items()):
        parts.append(f"<h3>{_esc(mname)}</h3>")
        rows = []
        for cname, cdoc in sorted((mdoc.get("coordinates") or {}).items()):
            c = cdoc.get("coefficients") or {}
            q = c.get("quantiles") or {}
            rows.append(
                [
                    _esc(cname),
                    _esc(cdoc.get("type")),
                    _fmt(c.get("n_nonzero")),
                    _fmt(c.get("sparsity")),
                    _fmt(c.get("l1_norm")),
                    _fmt(c.get("l2_norm")),
                    _fmt(q.get("p50")),
                    _fmt(c.get("max_abs")),
                ]
            )
        parts.append(
            _table(
                ["coordinate", "type", "nnz", "sparsity", "L1", "L2",
                 "median w", "max |w|"],
                rows,
            )
        )
        for cname, cdoc in sorted((mdoc.get("coordinates") or {}).items()):
            top = (cdoc.get("coefficients") or {}).get("top_features") or []
            if top:
                parts.append(
                    f"<h3>{_esc(cname)}: top features by |weight|</h3>"
                )
                parts.append(
                    _table(
                        ["feature", "weight"],
                        [[_esc(t["feature"]), _fmt(t["weight"])] for t in top],
                    )
                )
            shrink = cdoc.get("shrinkage")
            if shrink:
                parts.append(
                    f"<h3>{_esc(cname)}: shrinkage "
                    f"({_fmt(shrink.get('n_entities'))} entities)</h3>"
                )
                parts.append(
                    _table(
                        ["support size", "entities", "mean ‖w‖", "min", "max"],
                        [
                            [_esc(b["support"]), _fmt(b["n_entities"]),
                             _fmt(b["mean_norm"]), _fmt(b["min_norm"]),
                             _fmt(b["max_norm"])]
                            for b in shrink.get("histogram") or []
                        ],
                    )
                )

    # -- performance -------------------------------------------------------
    parts.append("<h2>Performance</h2>")
    timeline = perf.get("timeline") or {}
    if timeline:
        total = timeline.get("total") or {}
        phases = total.get("phases") or {}
        rows = [[_esc(p), _fmt(s)] for p, s in sorted(phases.items())]
        rows.append(["<i>overlap factor</i>", _fmt(total.get("overlap_factor"))])
        parts.append(_table(["phase", "seconds"], rows))
        ofs = timeline.get("overlap_factor_per_sweep") or []
        if ofs:
            parts.append(
                f"<p>overlap factor per sweep {sparkline_svg(ofs)}</p>"
            )
    if perf.get("compile_seconds"):
        parts.append(
            f'<p class="kv"><span>compile <b>{_fmt(perf["compile_seconds"])} s'
            "</b></span></p>"
        )
    streaming = perf.get("streaming") or {}
    if streaming:
        parts.append("<h3>Streaming slice utilization</h3>")
        parts.append(
            _table(
                ["site", "slices", "staged", "budget", "peak slice",
                 "headroom", "utilization"],
                [
                    [
                        _esc(site),
                        _fmt(s.get("slices_staged")),
                        _bytes_h(s.get("staged_bytes")),
                        _bytes_h(s.get("budget_bytes")),
                        _bytes_h(s.get("actual_slice_bytes")),
                        _bytes_h(s.get("budget_headroom_bytes")),
                        _fmt(s.get("budget_utilization")),
                    ]
                    for site, s in sorted(streaming.items())
                ],
            )
        )

    # -- bench trajectory --------------------------------------------------
    bench = report.get("bench") or {}
    progress = bench.get("progress") or []
    if progress:
        parts.append("<h2>Bench trajectory</h2>")
        series_names: List[str] = []
        for row in progress:
            for name in row.get("series") or {}:
                if name not in series_names:
                    series_names.append(name)
        rows = []
        for name in series_names:
            vals = [
                (row.get("series") or {}).get(name, {}).get("new")
                for row in progress
            ]
            deltas = [
                (row.get("series") or {}).get(name, {}).get("delta_pct")
                for row in progress
            ]
            last_delta = next((d for d in reversed(deltas) if d is not None), None)
            rows.append(
                [_esc(name), sparkline_svg(vals),
                 _fmt(vals[-1] if vals else None),
                 _fmt(last_delta) + ("%" if last_delta is not None else "")]
            )
        parts.append(
            _table(["series", "trajectory", "latest", "last Δ%"], rows)
        )
        if any(row.get("regressed") for row in progress):
            parts.append(
                '<p class="aborted">at least one recorded diff regressed '
                "beyond tolerance</p>"
            )
    diff = bench.get("diff") or {}
    if diff:
        parts.append("<h3>Baseline diff</h3>")
        parts.append(
            _table(
                ["series", "old", "new", "Δ%"],
                [
                    [_esc(name), _fmt(d["old"]), _fmt(d["new"]),
                     _fmt(d["delta_pct"])]
                    for name, d in sorted(diff.items())
                ],
            )
        )

    # -- flight recorder ---------------------------------------------------
    flight = report.get("flight") or []
    if flight:
        parts.append("<h2>Flight recorder</h2>")
        parts.append(
            '<p class="aborted">anomaly postmortems were dumped during '
            "this run</p>"
        )
        parts.append(
            _table(
                ["trigger", "detail", "process", "replica", "events",
                 "dump"],
                [
                    [_esc(d.get("trigger")), _esc(d.get("detail")),
                     _fmt(d.get("process_index")), _esc(d.get("replica")),
                     _fmt(d.get("n_events")), _esc(d.get("path"))]
                    for d in flight
                ],
            )
        )

    # -- checkpoints -------------------------------------------------------
    ckpts = report.get("checkpoints") or []
    if ckpts:
        parts.append("<h2>Boundary checkpoints</h2>")
        parts.append(
            _table(
                ["step", "sweep", "coordinate", "payload"],
                [
                    [_fmt(c.get("step")), _fmt(c.get("iteration")),
                     _esc(c.get("coordinate")), _bytes_h(c.get("bytes"))]
                    for c in ckpts
                ],
            )
        )

    return (
        "<!doctype html><html><head><meta charset=\"utf-8\">"
        f"<title>photon-ml-tpu report</title><style>{_CSS}</style></head>"
        "<body>" + "".join(parts) + "</body></html>"
    )


def write_report(report: dict, out_dir: str) -> Dict[str, str]:
    """Write report.json (sorted keys — byte-identical rebuilds) and
    report.html atomically; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    json_path = os.path.join(out_dir, REPORT_JSON)
    html_path = os.path.join(out_dir, REPORT_HTML)
    atomic_write_json(json_path, report, indent=2, sort_keys=True, default=float)
    with atomic_write(html_path, "w") as f:
        f.write(render_html(report))
    return {"json": json_path, "html": html_path}
