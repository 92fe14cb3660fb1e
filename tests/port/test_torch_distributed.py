"""The port's `parallel/distributed.py` across two real processes: two
gloo processes of 4 CPU shards each form one 8-shard global mesh
(`torch_distributed_worker.py`), as `tests/test_distributed.py` runs the
JAX package's over `jax.distributed`. The summed metrics must agree across
the processes, equal the one-process run over the same 8 shards, and
count `16·8·8` steps; after one fused train step over the job both ranks
hold the same params and Adam moments, the moments per leaf within
`MOMENT_TOL` of the one-process step's (the gradient sums meet in another
order), the params within 2·lr. This file imports no JAX."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

WORKER = Path(__file__).parent / "torch_distributed_worker.py"
REPO = WORKER.parents[2]
sys.path.insert(0, str(WORKER.parent))

import torch_distributed_worker as worker  # noqa: E402

from minigrid_tpu_torch.parallel import train  # noqa: E402
from minigrid_tpu_torch.parallel.packed import gather_carry  # noqa: E402
from minigrid_tpu_torch.parallel.sharding import make_env_mesh  # noqa: E402
from minigrid_tpu_torch.testing import moment_gaps  # noqa: E402

MOMENT_TOL = 1e-5  # test_torch_parallel_train.py's bound on the 8-shard fused step against one device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_global_mesh_equals_one_process(tmp_path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), str(port), str(rank), "2", str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(REPO), env=env)
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    lines = [[x for x in out.splitlines() if x.startswith("METRICS ")][-1].split()[1:] for out in outs]
    assert lines[0] == lines[1]
    episodes, total_steps, checksum, overlaps, reward, env_steps, train_episodes = lines[0]
    assert int(total_steps) == 16 * 8 * 8
    assert int(env_steps) == 16 * 8 * worker.TRAIN_T

    torch.set_num_threads(1)
    metrics, ts, carries, tm = worker.run(make_env_mesh(["cpu"] * 8))
    assert [int(episodes), int(checksum), int(overlaps)] == [int(metrics.episodes), int(metrics.obs_checksum),
                                                               int(metrics.reset_overlaps)]
    np.testing.assert_allclose(float(reward), float(metrics.total_reward), rtol=1e-6)
    assert int(env_steps) == int(tm["env_steps"]) and float(train_episodes) == float(tm["episodes"])
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for name in ("params", "mu", "nu"):
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name], err_msg=name)
    one = train.flatten_params(ts.params.flax_params()).numpy()
    assert np.abs(ranks[0]["params"] - one).max() <= 2 * train.LR
    opt = train.AdamState(ts.opt_state.count, *(torch.from_numpy(ranks[0][m]) for m in ("mu", "nu")))
    for leaf, gaps in moment_gaps(train.TrainState(ts.params, opt), ts).items():
        assert max(gaps) <= MOMENT_TOL, (leaf, gaps)
    words = gather_carry(carries).words.numpy()
    np.testing.assert_array_equal(np.concatenate([ranks[0]["words"], ranks[1]["words"]], axis=1), words)
