"""The train cell on the CPU at a few lanes: the reference following the
port's plain train step, its control at lower precision, and the faults a
train step can have, each planted in the port's timed path before
set-up (the checked steps are set-up's and one of the window's)."""

import pytest
import torch

from gpubench_helpers import ROOT, tiny_cell


def _run(**kw):
    from gpubench.harness import runner

    return runner.run(tiny_cell("empty8x8.train"), 2**31 + 3, 0.0, False, torch.device("cpu"), 0.0, **kw)


def test_reference_follows_the_port():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["checks"]["env_lanes_wrong"]["value"] == 0


def test_fp8_control_fails():
    from gpubench.harness import spec

    cell = tiny_cell("empty8x8.train")
    mode = spec.mode_module(cell).Mode(cell, 21, torch.device("cpu"))
    for i in range(mode.min_calls):
        mode.call(i, lambda _p: None)
    r = mode.readings(("fp8",))
    assert all(c.ok for c in r[None])
    assert not all(c.ok for c in r["fp8"])


def _unchanged(build, after=0):
    """Steps that leave the train state as it was, from call `after` on."""

    def build_broken(*a, **k):
        step, calls = build(*a, **k), []

        def broken(ts, carry, key, mark=None):
            ts2, carry2, metrics = step(ts, carry, key)
            calls.append(1)
            return (ts if len(calls) > after else ts2), carry2, metrics

        return broken

    return build_broken


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "unchanged_in_window"])
def test_broken_train_step_is_not_correct(fault, monkeypatch):
    from minigrid_tpu_torch.ops import policy_rollout
    from minigrid_tpu_torch.parallel import train

    if fault == "half_batch":
        from gpubench import limits

        limits.plant("half_batch", monkeypatch.setattr)
    elif fault == "altered":
        run = policy_rollout.run_policy_kernel

        def altered(*a, **k):
            out = run(*a, **k)
            actions = out[5][1]  # the trajectory's actions, a view of the spill
            actions[3, 2] = (actions[3, 2] + 1) % 7
            return out

        monkeypatch.setattr(policy_rollout, "run_policy_kernel", altered)
    else:  # from the first call, or only once set-up's steps are done
        after = 3 if fault == "unchanged_in_window" else 0
        monkeypatch.setattr(train, "build_fused_train_step", _unchanged(train.build_fused_train_step, after))
    res = _run()
    assert not res["correct"], res["checks"]
    if fault == "half_batch":  # the whole batch stepped: the world is right, the update is not
        assert res["checks"]["env_lanes_wrong"]["value"] == 0



def _mesh_cell(tmp_path):
    """A four-card train cell defined by files and entries alone: four CPU
    shards of 8 lanes. Limits read at this size: sound, a loss gap of
    3.2e-5 and a first-gradient gap of 8.8e-5; with the exchange left out
    0.20 and 0.77."""
    import json
    import shutil

    from gpubench.harness import spec

    bench_dir = tmp_path / "gpubench"
    shutil.copytree(ROOT / "gpubench", bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (bench_dir / "workloads" / "empty8x8.train.mesh4.json").write_text(json.dumps(dict(
        json.loads((bench_dir / "workloads" / "empty8x8.train.json").read_text()), chips=4, batch=32, steps=48,
        reference_chunk=8, trace_calls=1,
        limits=dict(cdf_gap=0.002, update_gap=0.025, loss_gap=0.05, grad_gap=0.3))))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "empty8x8.train.mesh4", "config": "empty8x8", "traffic": "train", "chips": 4,
                               "why": "a fixture"})
    return spec.load_cell("empty8x8.train.mesh4", bench, bench_dir)


def test_mesh_reference_follows_the_port(tmp_path):
    from gpubench.harness import runner

    res = runner.run(_mesh_cell(tmp_path), 2**31 + 3, 0.0, False, torch.device("cpu"), 0.0)
    assert res["correct"], res["checks"]


def test_mesh_exchange_left_out_is_not_correct(tmp_path, monkeypatch):
    """The shards' sums not exchanged: only the first shard's gradient
    and loss reach Adam and the metrics."""
    from gpubench import limits
    from gpubench.harness import runner

    limits.plant("exchange", monkeypatch.setattr)
    res = runner.run(_mesh_cell(tmp_path), 2**31 + 3, 0.0, False, torch.device("cpu"), 0.0)
    assert not res["correct"]
    assert not all(res["checks"][k]["value"] <= res["checks"][k]["limit"] for k in ("loss_gap", "grad_gap"))
