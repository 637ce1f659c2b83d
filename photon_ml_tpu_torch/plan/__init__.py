"""Execution-plan layer: one planner for the run's whole configuration
(the JAX package's ``plan``). :func:`resolve` maps the per-coordinate
configuration to a typed, introspectable :class:`ExecutionPlan`, or raises
one typed :class:`PlanError`; the compositions the port has not ported
raise naming their ROADMAP item."""

from .planner import (
    CoordinatePlan,
    ExecutionPlan,
    PlanError,
    check_checkpoint_topology,
    check_fleet_composition,
    check_lane_composition,
    check_multiprocess_mesh,
    check_retrain_composition,
    plan_fingerprint,
    resolve,
)

__all__ = [
    "CoordinatePlan",
    "ExecutionPlan",
    "PlanError",
    "check_checkpoint_topology",
    "check_fleet_composition",
    "check_lane_composition",
    "check_multiprocess_mesh",
    "check_retrain_composition",
    "plan_fingerprint",
    "resolve",
]
