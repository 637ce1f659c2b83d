"""Shared pieces of the port's serving tests (tests/test_torch_serving*.py,
tests/test_torch_overload.py): one small GLMix model made from a seed with
numpy and built in both packages, requests, the numpy oracle, counters,
and the thread census that holds every file to closing what it starts."""

from __future__ import annotations

import json
import socket
import threading

import jax.numpy as jnp
import numpy as np
import torch

from photon_ml_tpu import serving as ref_serving
from photon_ml_tpu.models.game import FixedEffectModel as RefFixedEffectModel
from photon_ml_tpu.models.game import GameModel as RefGameModel
from photon_ml_tpu.models.game import RandomEffectModel as RefRandomEffectModel
from photon_ml_tpu.models.glm import Coefficients as RefCoefficients
from photon_ml_tpu.models.glm import LogisticRegressionModel as RefLogisticModel
from photon_ml_tpu_torch import convert, serving

D_FIXED = 6
D_RE = 4


def model_parts(fe_shift=0.0, seed=0, with_re=True):
    """The reference tests' small two-coordinate GLMix model (the same draws
    from the same seed), as ``convert``'s numpy dict."""
    rng = np.random.default_rng(seed)
    models = {"global": {
        "kind": "fixed", "feature_shard": "globalShard", "task": "logistic_regression",
        "means": rng.standard_normal(D_FIXED) + fe_shift, "variances": None,
    }}
    if with_re:
        models["per-user"] = {
            "kind": "random", "random_effect_type": "userId", "feature_shard": "userShard",
            "task": "logistic_regression", "entity_ids": np.asarray(["uA", "uB", "uC"], dtype=object),
            "coef_indices": np.asarray([[0, 2, -1], [1, 3, -1], [0, 1, 2]], np.int32),
            "coef_values": rng.standard_normal((3, 3)), "variances": None,
        }
    return {"task": "logistic_regression", "models": models}


def port_model(parts, dtype=torch.float64):
    return convert.game_model_from_numpy(parts, dtype=dtype, device="cpu")


def ref_model(parts):
    models = {}
    for name, p in parts["models"].items():
        if p["kind"] == "fixed":
            models[name] = RefFixedEffectModel(
                model=RefLogisticModel(RefCoefficients(jnp.asarray(p["means"]))),
                feature_shard=p["feature_shard"],
            )
        else:
            models[name] = RefRandomEffectModel(
                random_effect_type=p["random_effect_type"], feature_shard=p["feature_shard"],
                task=p["task"], entity_ids=p["entity_ids"],
                coef_indices=jnp.asarray(p["coef_indices"]), coef_values=jnp.asarray(p["coef_values"]),
            )
    return RefGameModel(models=models, task=parts["task"])


def make_request(rng, uid, model=None):
    """nnz 4 on the global shard, 2 on the user shard (both within the
    smallest width rung), as the reference tests draw them."""
    gidx = np.sort(rng.choice(D_FIXED, size=4, replace=False))
    uidx = np.sort(rng.choice(D_RE, size=2, replace=False))
    return serving.ScoreRequest(
        features={
            "globalShard": (tuple(int(i) for i in gidx), tuple(rng.standard_normal(4).tolist())),
            "userShard": (tuple(int(i) for i in uidx), tuple(rng.standard_normal(2).tolist())),
        },
        ids={"userId": uid},
        offset=float(rng.standard_normal()),
        model=model,
    )


def to_ref(req):
    return ref_serving.ScoreRequest(features=req.features, ids=req.ids, offset=req.offset, model=req.model)


def to_doc(req):
    doc = {"features": {k: [list(v[0]), list(v[1])] for k, v in req.features.items()},
           "ids": dict(req.ids), "offset": req.offset}
    if req.model is not None:
        doc["model"] = req.model
    return doc


def oracle_score(parts, req):
    """Hand-assembled float64 numpy oracle: offset + FE dot + (RE dot, or 0
    for an unseen entity)."""
    total = req.offset
    w = parts["models"]["global"]["means"]
    gi, gv = req.features["globalShard"]
    total += float(np.dot(w[np.asarray(gi)], np.asarray(gv)))
    re = parts["models"].get("per-user")
    uid = req.ids.get("userId")
    if re is not None and uid in list(re["entity_ids"]):
        row = list(re["entity_ids"]).index(uid)
        coef = {int(c): float(v) for c, v in zip(re["coef_indices"][row], re["coef_values"][row]) if int(c) >= 0}
        ui, uv = req.features["userShard"]
        total += sum(coef.get(int(c), 0.0) * float(v) for c, v in zip(ui, uv))
    return total


def counter_total(run, name, **labels):
    total = 0.0
    for m in run.registry.snapshot():
        if m["name"] == name and m["kind"] == "counter":
            got = m.get("labels", {})
            if all(got.get(k) == v for k, v in labels.items()):
                total += m["value"]
    return total


def serve_tcp(server_like, serve_fn):
    """A TCP listener for ``server_like`` on an ephemeral port; returns
    (addr, stop_event, thread)."""
    stop, ready, bound = threading.Event(), threading.Event(), {}
    t = threading.Thread(
        target=serve_fn, args=(server_like,),
        kwargs=dict(listen="127.0.0.1:0", stop_event=stop,
                    on_bound=lambda a: (bound.update(addr=a), ready.set())),
        daemon=True,
    )
    t.start()
    assert ready.wait(10.0)
    host, port = bound["addr"][:2]
    return f"{host}:{port}", stop, t


def rpc(addr, doc=None, raw=None):
    """One request line over a fresh connection; the decoded response."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port))) as s, s.makefile("rwb") as f:
        f.write(raw if raw is not None else (json.dumps(doc) + "\n").encode())
        f.flush()
        return json.loads(f.readline())


def serving_threads():
    """The live threads the serving stack starts: batcher workers, refresh
    watchers, warmers, fronts and their readers, introspection servers, and
    the socket listeners' connection handlers."""
    return {
        t for t in threading.enumerate()
        if t.name.startswith(("photon-serving", "photon-introspection"))
        or "_handle_conn" in t.name or "_front_conn_handler" in t.name
    }
