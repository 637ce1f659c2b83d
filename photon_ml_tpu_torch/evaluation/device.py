"""Device-side validation metrics on torch tensors.

Counterpart of the JAX package's ``evaluation/device.py``. ``auc`` is the
weighted trapezoidal AUC with tied scores grouped: after a stable sort by
descending score, each tie group's positive and negative weights come from
differences of running sums at the group ends (no scatter, so no atomics
and the same bits on every run). NaN for a single-class batch. Sums run in
float64.

``build_device_evaluator`` computes every requested metric where the scores
lie and brings them to the host in one fetch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

Tensor = torch.Tensor

POSITIVE_THRESHOLD = 0.5


def auc(s: Tensor, y: Tensor, w: Tensor) -> Tensor:
    order = torch.argsort(-s, stable=True)
    s, y, w = s[order], y[order], w[order].to(torch.float64)
    zero = torch.zeros_like(w)
    pos = torch.where(y > POSITIVE_THRESHOLD, w, zero)
    neg = torch.where(y > POSITIVE_THRESHOLD, zero, w)
    n = s.shape[0]
    # last index of each tie group
    last = torch.ones(n, dtype=torch.bool, device=s.device)
    last[:-1] = s[1:] != s[:-1]
    cpos = torch.cumsum(pos, 0)[last]
    cneg = torch.cumsum(neg, 0)[last]
    gp = torch.diff(cpos, prepend=cpos.new_zeros(1))
    gn = torch.diff(cneg, prepend=cneg.new_zeros(1))
    cum_before = cpos - gp
    raw = torch.sum(cum_before * gn + gp * gn / 2.0)
    tp, tn = cpos[-1], cneg[-1]
    nan = torch.full((), float("nan"), dtype=raw.dtype, device=raw.device)
    return torch.where((tp == 0.0) | (tn == 0.0), nan, raw / (tp * tn))


def rmse(s: Tensor, y: Tensor, w: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(w * (s - y) ** 2) / torch.sum(w))


def _mean(loss: Tensor, w: Tensor) -> Tensor:
    return torch.sum(w * loss) / torch.sum(w)


def logistic_loss(s: Tensor, y: Tensor, w: Tensor) -> Tensor:
    yb = (y > POSITIVE_THRESHOLD).to(s.dtype)
    loss = torch.log1p(torch.exp(-torch.abs(s))) + torch.clamp(s, min=0.0) - yb * s
    return _mean(loss, w)


def poisson_loss(s: Tensor, y: Tensor, w: Tensor) -> Tensor:
    return _mean(torch.exp(s) - y * s, w)


def squared_loss(s: Tensor, y: Tensor, w: Tensor) -> Tensor:
    # the squared loss carries the GLM 1/2 factor
    return _mean(0.5 * (s - y) ** 2, w)


def smoothed_hinge_loss(s: Tensor, y: Tensor, w: Tensor) -> Tensor:
    """Rennie's smoothed hinge on the margin in {-1, 1} space."""
    z = torch.where(y > POSITIVE_THRESHOLD, 1.0, -1.0).to(s.dtype) * s
    zero = torch.zeros_like(z)
    loss = torch.where(z >= 1.0, zero, torch.where(z <= 0.0, 0.5 - z, 0.5 * (1.0 - z) ** 2))
    return _mean(loss, w)


DEVICE_METRICS = {
    "AUC": auc,
    "RMSE": rmse,
    "LOGISTIC_LOSS": logistic_loss,
    "POISSON_LOSS": poisson_loss,
    "SQUARED_LOSS": squared_loss,
    "SMOOTHED_HINGE_LOSS": smoothed_hinge_loss,
}


def build_device_evaluator(evaluators, labels: np.ndarray, weights) -> Optional[Callable]:
    """A function ``scores -> {name: float}`` computing every (ungrouped,
    device-supported) metric of ``evaluators`` on the scores' device, with
    one stacked fetch; None when any metric needs the host path (grouped or
    ranking metrics). Labels and weights move to the scores' device, in
    float32, at the first call."""
    names = []
    for e in evaluators:
        if e.group_by is not None or e.name not in DEVICE_METRICS:
            return None
        names.append(e.name)
    fns = [DEVICE_METRICS[n] for n in names]
    y_host = torch.as_tensor(np.asarray(labels, dtype=np.float32))
    w_host = torch.ones_like(y_host) if weights is None else torch.as_tensor(
        np.asarray(weights, dtype=np.float32)
    )
    on_device: Dict[torch.device, tuple] = {}

    def evaluate(scores: Tensor) -> Dict[str, float]:
        dev = scores.device
        if dev not in on_device:
            on_device[dev] = (y_host.to(dev), w_host.to(dev))
        y, w = on_device[dev]
        s = scores.to(y.dtype)
        vals = torch.stack([f(s, y, w).to(torch.float64) for f in fns]).cpu().numpy()
        return {n: float(v) for n, v in zip(names, vals)}

    return evaluate
