"""The metric arithmetic on synthetic inputs, and the kernels' counts
worked by hand at a small shape."""

import pytest

from gpubench_helpers import ROOT, tiny_cell


def _run(**kw):
    from gpubench.harness.runner import Run

    cell = tiny_cell("empty8x8.random")
    args = dict(cell=cell, setup_s=1.5, calls_s=[0.1] * 9 + [1.0], window_s=2.0, work_per_call=1000)
    args.update(kw)
    return Run(**args)


def _read(name, run):
    from gpubench.harness import spec

    return spec.load_module(ROOT / "gpubench" / "metrics" / f"{name}.py", "m_" + name.replace(".", "_")).read(run)


def test_rate_is_all_work_over_all_time():
    # 10 calls of 1000 env-steps in a 2 s window, whatever the calls' own times.
    assert _read("env_steps_per_s", _run()) == 5000.0
    assert _read("regen_env_steps_per_s", _run(window_s=4.0)) == 2500.0


def test_p90_over_all_calls():
    # 1..100 ms: the inclusive 90th percentile is 90.1 ms.
    run = _run(calls_s=[i / 1000 for i in range(1, 101)])
    assert _read("call_ms_p90", run) == pytest.approx(90.1)
    assert _read("call_ms_p90.regen", run) == pytest.approx(90.1)
    assert _read("call_ms_p90", _run(calls_s=[0.1] * 95 + [5.0] * 5)) == pytest.approx(100.0)


def test_pieces_and_counters():
    marks = [[("actions", 1.0), ("kernel", 20.0), ("rng", 40.0), ("sums", 0.5)],
             [("actions", 1.0), ("kernel", 22.0), ("rng", 44.0), ("sums", 0.5)]]
    run = _run(calls_s=[0.1, 0.1], marks=marks, counters={"chunked_regen.host_syncs": 32})
    assert _read("carry.rng_ms", run) == 42.0
    assert _read("regen.refresh_ms", run) is None
    assert _read("regen.host_syncs", run) == 16.0
    refresh = [[("actions", 1.0), ("kernel", 3.0), ("refresh", 10.0), ("reentry", 1.0), ("kernel", 3.0),
                ("refresh", 30.0), ("reentry", 1.0), ("sums", 0.1)]]
    assert _read("regen.refresh_ms", _run(calls_s=[0.1], marks=refresh)) == 40.0


def test_idle_from_overlapping_intervals():
    from gpubench.harness import stats
    from gpubench.harness.trace import END_OF_CALL, Trace

    # Window 0..100 us; kernels 10-30 and 20-40 overlap (30 us busy), 60-70 (10 us).
    iv = [(10.0, 30.0), (20.0, 40.0), (60.0, 70.0)]
    assert stats.union_length(iv, 0, 100) == 40.0
    assert stats.idle_pct(iv, 0, 100) == 60.0
    assert stats.gaps(iv, 0, 100) == [(0, 10.0), (40.0, 60.0), (70.0, 100)]
    tr = Trace(0.0, 100.0, 2, {0: [(10.0, 30.0, "rollout_cells16<...>"), (20.0, 40.0, "elementwise"),
                                   (60.0, 70.0, "rollout_cells16<...>")]},
               [(0.0, 50.0, "kernel"), (50.0, 80.0, "rng"), (80.0, 100.0, END_OF_CALL)])
    assert tr.busy_s(0) == pytest.approx(40e-6) and tr.window_s == pytest.approx(100e-6)
    assert tr.kernel_s("rollout_cells16") == pytest.approx(30e-6)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["rollout_cells16<...>", pytest.approx(30e-6)]
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        "kernel": pytest.approx(20e-6), END_OF_CALL: pytest.approx(20e-6), "rng": pytest.approx(20e-6)}
    assert _read("device_idle_pct.rollout", _run(traced=tr)) == pytest.approx(60.0)
    # Over two cards, the mean of their idle shares; a card with no
    # activity at all is idle throughout.
    two = tiny_cell("empty8x8.random")
    two.chips = 2
    tr.devices[1] = [(0.0, 100.0, "k")]
    assert _read("device_idle_pct.regen", _run(cell=two, traced=tr)) == pytest.approx(30.0)
    del tr.devices[1]
    assert _read("device_idle_pct.train", _run(cell=two, traced=tr)) == pytest.approx(80.0)


def test_b1_bytes_by_hand():
    """B1 at 8x8, B = 2, T = 3: words and registers in and out and the
    templates in, (3·64 + 3·42)·2 words; 3·2 actions; 3 int32 sums a lane
    out: 4·(384 + 252 + 6) + 24 = 2592 bytes."""
    from gpubench.harness.stats import HBM_BYTES_PER_S
    from gpubench.harness.trace import Trace

    from gpubench.harness import spec

    reader = spec.load_module(ROOT / "gpubench" / "metrics" / "b1_roofline.py", "b1")
    assert reader.state_bytes(64, 2, 3) == 2592
    # Empty-8x8 at the cell's shape: 4.84 GB a call.
    assert reader.state_bytes(64, 2_097_152, 256) == 4_815_060_992 + 25_165_824
    cell = tiny_cell("empty8x8.random", batch=2, steps=3)
    tr = Trace(0.0, 10.0, 1, {0: [(0.0, 1.0, "void rollout_cells16<0, false, 1, 7>(Params)")]})
    pct = reader.read(_run(cell=cell, traced=tr))
    assert pct == pytest.approx(100.0 * 2592 / HBM_BYTES_PER_S / 1e-6)
    assert reader.read(_run(cell=cell, traced=Trace(0.0, 10.0, 1, {0: [(0.0, 1.0, "other")]}))) is None


def test_b2_b3_and_model_counts_by_hand():
    """At V = 7, 8x8, B = 2, T = 3. The weights: W1 256·49·20 and W2
    256·256 bf16, two bf16 biases of 256, eight f32 head rows of 257:
    501,760 + 131,072 + 1,024 + 8,224 = 642,080 bytes. A sample's forward:
    147 one-hot rows of 256, the 256 x 256 product, the 8-row head, 172,800
    operations; its backward 8,192 + 262,144 + 37,632 = 307,968; together
    480,768."""
    from gpubench.harness import counts

    assert counts.weight_bytes(7) == 642_080
    assert counts.policy_flop(7) == 172_800
    assert counts.model_flop(7) == 480_768
    # B2: the state (2,592 bytes), the weights, a 56-row spill a lane-step.
    assert counts.b2_counts(64, 7, 2, 3) == (2_592 + 642_080 + 4 * 56 * 6, 172_800 * 6)
    # B3: 49 obs words, the action, advantage and return a sample; the
    # weights read and their gradients written.
    assert counts.b3_counts(7, 2, 3) == (4 * 52 * 6 + 2 * 642_080, 480_768 * 6)


def test_mfu_from_the_window_rate():
    from gpubench.harness.stats import BF16_FLOP_PER_S

    cell = tiny_cell("empty8x8.train")
    run = _run(cell=cell, calls_s=[0.5] * 4, window_s=2.0, work_per_call=1_000_000)
    assert _read("train.mfu_pct", run) == pytest.approx(100.0 * 480_768 * 2e6 / BF16_FLOP_PER_S)
