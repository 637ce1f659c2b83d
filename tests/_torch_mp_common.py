"""Helpers of the port's multi-process tests (tests/test_torch_distributed.py,
test_torch_multihost.py, test_torch_re_build.py, test_torch_fleet.py):
the JAX suite's fixtures written by the port's Avro writer, and a launcher
that starts one ``python -m photon_ml_tpu_torch.<cli>`` process a rank,
joined at a free local port (gloo on the CPU and for ranks sharing a card),
each under its own timeout. The callers pass ``--device``; every rank runs
with two intra-op threads, so that two ranks of a test and the tests of
other workers do not oversubscribe the host."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_logistic_avro(path, n=320, d=6, seed=7):
    """tests/test_multihost.py's ``_write_data`` (and test_distributed.py's
    ``_write_logistic_avro``): n logistic rows of d named features."""
    from photon_ml_tpu_torch.io import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    w = rng.normal(size=d)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(x @ w)))).astype(int)
    recs = [
        {"label": float(y[i]), "features": [{"name": f"f{j}", "term": "", "value": float(x[i, j])} for j in range(d)]}
        for i in range(n)
    ]
    write_avro_file(str(path), TRAINING_EXAMPLE_AVRO, recs)
    return str(path)


def write_glmix_avro(path, n=640, seed=21, n_users=12, d_re=3):
    """tests/test_multihost.py's ``_write_glmix_data``: global and per-user
    feature bags with userId ids."""
    from photon_ml_tpu_torch.io import write_avro_file
    from photon_ml_tpu_torch.io.schemas import TRAINING_EXAMPLE_AVRO
    from photon_ml_tpu_torch.testing import generate_game_records, generate_mixed_effect_data

    data = generate_mixed_effect_data(n=n, d_fixed=5, re_specs={"userId": (n_users, d_re)}, seed=seed)
    schema = {
        **TRAINING_EXAMPLE_AVRO,
        "fields": TRAINING_EXAMPLE_AVRO["fields"]
        + [{"name": "userFeatures", "type": {"type": "array", "items": "FeatureAvro"}, "default": []}],
    }
    write_avro_file(str(path), schema, generate_game_records(data))
    return str(path)


def build_index(data, shard_args, out):
    from photon_ml_tpu_torch.cli import index as index_cli

    index_cli.run(["--input-data", data, *shard_args, "--output-dir", str(out)])
    return str(out)


def launch(cli, argv, world=2, extra_by_rank=None, env_by_rank=None, timeout_s=RANK_TIMEOUT_S):
    """Run ``python -m photon_ml_tpu_torch.cli.<cli> argv --distributed
    coordinator=127.0.0.1:PORT,process=i,n=world`` as ``world`` processes;
    returns ``[(returncode, stdout, stderr)]`` in rank order. A rank still
    running after ``timeout_s`` fails the test (every rank is killed)."""
    port = free_port()
    procs = []
    for i in range(world):
        env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
        env.pop("PHOTON_FAULTS", None)
        env.update((env_by_rank or {}).get(i, {}))
        cmd = [
            sys.executable, "-m", f"photon_ml_tpu_torch.cli.{cli}", *argv,
            *((extra_by_rank or {}).get(i, ())),
            "--distributed", f"coordinator=127.0.0.1:{port},process={i},n={world}",
        ]
        procs.append(subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            pytest.fail(f"{cli} --distributed over {world} ranks ran past {timeout_s:.0f} s")
        outs.append((p.returncode, out, err))
    return outs


def assert_ok(outs):
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {i} exited {rc}:\n{out[-3000:]}\n{err[-6000:]}"
