"""The port's pipeline-gap attribution against the reference's, on the CPU.

``predictionio_tpu_torch.tools.attribute_gap`` reads a round's
``tpu_era`` rates and per-model step-timeline summaries.  On the same
inputs its standard output (text and ``--json``), standard error and
exit code must equal the reference's ``tools/attribute_gap.py`` (loaded
from its path; it imports no JAX), character for character.  The
inputs: the committed rounds ``BENCH_r06.json`` and ``BENCH_r07.json``,
their ``--compare``, a capture wrapping a round in its ``tail``
(whole, and cut so the blocks are brace-scanned), a ``--timeline`` file
of the port's ``StepTimeline.summary`` after a small seeded two-tower
train, and a ``/timeline.json`` served by the port's admin server.

:func:`gap_block` on CPU-sized two-tower and DLRM runs: the eight flat
keys of the reference's rounds, the gap ``100·(1 − pipeline/device)``,
and the block attributes as the reference attributes it.
"""

import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.obs.runtime import get_timeline
from predictionio_tpu_torch.tools import attribute_gap

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_attribute_gap", ROOT / "tools" / "attribute_gap.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_tool()


def _run(mod, argv, capsys):
    try:
        code = mod.main(argv)
    except SystemExit as e:          # argparse's refusals
        code = e.code
    out = capsys.readouterr()
    return code, out.out, out.err


def same_output(argv, capsys):
    runs = [_run(mod, [str(a) for a in argv], capsys)
            for mod in (REF, attribute_gap)]
    assert runs[1] == runs[0]
    return runs[1]


# -- small seeded runs on the CPU --------------------------------------------

TT = dict(n_users=300, n_items=200, embed_dim=8, hidden_dims=(16,),
          out_dim=8, batch_size=64, epochs=1, seed=0)
DL = dict(vocab_sizes=(50,) * 3, n_dense=4, embed_dim=8, bottom_mlp=(16, 8),
          top_mlp=(16, 8), batch_size=64, epochs=1, seed=0)
ROWS = 2048
WINDOW = 8


def _two_tower_run():
    """(device rate, feeder rate, pipeline rate, timeline summary) of a
    small two-tower model, as ``chip_smoke.py`` measures them."""
    from predictionio_tpu_torch.models import two_tower as tt

    rng = np.random.default_rng(0)
    users = rng.integers(0, TT["n_users"], ROWS)
    items = rng.integers(0, TT["n_items"], ROWS)
    cfg = tt.TwoTowerConfig(**TT)
    init = tt.init_state(cfg, device=CPU)
    device = attribute_gap.two_tower_device_rate(init, cfg, users, items,
                                                 CPU)
    feeder = attribute_gap.feeder_rate(
        cfg.batch_size, user_ids=users.astype(np.uint32),
        item_ids=items.astype(np.uint32),
        values=np.ones(ROWS, np.float32))
    timeline = get_timeline()
    timeline.clear()
    t0 = time.perf_counter()
    tt.train(users, items, cfg, data_source="feeder", fuse_steps=WINDOW,
             warm_state=init, device=CPU)
    pipeline = ROWS / (time.perf_counter() - t0)
    return device, feeder, pipeline, timeline.summary("two_tower")


def _dlrm_run():
    from predictionio_tpu_torch.models import dlrm as dl

    rng = np.random.default_rng(1)
    dense = rng.standard_normal((ROWS, DL["n_dense"]), np.float32)
    cat = rng.integers(0, 50, (ROWS, len(DL["vocab_sizes"])))
    labels = (rng.random(ROWS) < 0.25).astype(np.float32)
    cfg = dl.DLRMConfig(**DL)
    init = dl.init_state(cfg, device=CPU)
    device = attribute_gap.dlrm_device_rate(init, cfg, dense, cat, labels,
                                            CPU)
    feeder = attribute_gap.feeder_rate(
        cfg.batch_size,
        cats=(cat + cfg.offsets[None, :]).astype(np.uint32),
        values=labels, extras=dense)
    timeline = get_timeline()
    timeline.clear()
    t0 = time.perf_counter()
    dl.train(dense, cat, labels, cfg, data_source="feeder",
             fuse_steps=WINDOW, warm_state=init, device=CPU)
    pipeline = ROWS / (time.perf_counter() - t0)
    return device, feeder, pipeline, timeline.summary("dlrm")


@pytest.fixture(scope="module")
def measured():
    runs = {"two_tower": _two_tower_run(), "dlrm": _dlrm_run()}
    get_timeline().clear()
    return runs


# -- the committed rounds -----------------------------------------------------

@pytest.mark.parametrize("fmt", [[], ["--json"]], ids=["text", "json"])
@pytest.mark.parametrize("bench", ["BENCH_r06.json", "BENCH_r07.json"])
def test_a_committed_round(bench, fmt, capsys):
    code, out, _ = same_output([ROOT / bench, *fmt], capsys)
    assert code == 0 and "two_tower" in out and "dlrm" in out


@pytest.mark.parametrize("fmt", [[], ["--json"]], ids=["text", "json"])
def test_compare_of_the_committed_rounds(fmt, capsys):
    code, out, _ = same_output(["--compare", ROOT / "BENCH_r06.json",
                                ROOT / "BENCH_r07.json", *fmt], capsys)
    assert code == 0 and "dominant" in out


def test_compare_refuses_a_timeline(capsys):
    code, _, err = same_output(["--compare", ROOT / "BENCH_r06.json",
                                ROOT / "BENCH_r07.json", "--timeline",
                                ROOT / "BENCH_r06.json"], capsys)
    assert code == 2 and "--timeline cannot be combined" in err


def _round(name):
    return json.loads((ROOT / name).read_text())


@pytest.mark.parametrize("cut", [False, True], ids=["whole", "cut"])
def test_a_round_capture(cut, tmp_path, capsys):
    r07 = _round("BENCH_r07.json")
    inner = json.dumps({"metric": "x", "tpu_era": r07["tpu_era"],
                        "timeline": r07["timeline"], "serving": {}})
    if cut:
        # a capture keeps only the last bytes: the line's head is gone
        inner = inner[len('{"metric": "x", '):]
    path = tmp_path / "capture.json"
    path.write_text(json.dumps({"round": 9, "tail": "stray\n" + inner}))
    for fmt in ([], ["--json"]):
        code, out, _ = same_output([path, *fmt], capsys)
        assert code == 0 and "no timeline data" not in out


def test_no_data_exits_one(tmp_path, capsys):
    path = tmp_path / "empty.json"
    path.write_text(json.dumps({"tpu_era": {}}))
    code, out, _ = same_output([path], capsys)
    assert code == 1 and out.count("no timeline data") == 2


# -- the port's own timelines -------------------------------------------------

def test_a_timeline_file_of_the_ports_summary(measured, tmp_path, capsys):
    summary = measured["two_tower"][3]
    assert summary["steps"] == ROWS // TT["batch_size"]
    path = tmp_path / "timeline.json"
    path.write_text(json.dumps({"two_tower": summary}))
    for fmt in ([], ["--json"]):
        code, out, _ = same_output([ROOT / "BENCH_r07.json", "--timeline",
                                    path, *fmt], capsys)
        assert code == 0
    assert "fusion depth: K=8" in same_output(
        [ROOT / "BENCH_r07.json", "--timeline", path], capsys)[1]


def test_a_live_timeline_json_of_the_ports_admin_server(tmp_path, capsys):
    from predictionio_tpu_torch.config import memory_config
    from predictionio_tpu_torch.data.storage import Storage
    from predictionio_tpu_torch.server.admin import AdminServer

    timeline = get_timeline()
    timeline.clear()
    for model in ("two_tower", "dlrm"):
        for step in range(4):
            timeline.record(model, host_wait_ms=1.0 + step,
                            h2d_ms=0.5, dispatch_ms=3.0,
                            device_wait_ms=0.25, examples=64 * WINDOW,
                            fused_steps=WINDOW)
    server = AdminServer(Storage(memory_config(tmp_path / "home")),
                         port=0)
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}/timeline.json"
        code, out, _ = same_output([ROOT / "BENCH_r07.json", "--timeline",
                                    url, "--json"], capsys)
        assert code == 0
        code, out, _ = same_output([ROOT / "BENCH_r07.json", "--timeline",
                                    url], capsys)
        # per model: host_wait 10, h2d 2, dispatch 12, device_wait 1 ms
        assert code == 0 and out.count("dominant: dispatch (48.0%") == 2
    finally:
        server.stop()
        timeline.clear()


# -- gap_block ------------------------------------------------------------------

KEYS = ("examples_per_sec_per_chip", "feeder_examples_per_sec",
        "pipeline_examples_per_sec", "pipeline_gap_pct")


def test_gap_block_on_cpu_sized_runs(measured, tmp_path, capsys):
    block = attribute_gap.gap_block(
        {m: dict(zip(("device", "feeder", "pipeline", "timeline"), run))
         for m, run in measured.items()})
    era = block["tpu_era"]
    assert sorted(era) == sorted(f"{m}_{k}" for m in ("two_tower", "dlrm")
                                 for k in KEYS)
    for model in ("two_tower", "dlrm"):
        dev = era[f"{model}_examples_per_sec_per_chip"]
        pipe = era[f"{model}_pipeline_examples_per_sec"]
        assert dev > 0 and pipe > 0 and era[f"{model}_feeder_"
                                            "examples_per_sec"] > 0
        assert era[f"{model}_pipeline_gap_pct"] == round(
            100 * (1 - pipe / dev), 1)
        assert block["timeline"]["models"][model]["fuse_steps"] == WINDOW
    got = attribute_gap.attribute(block)
    assert got == REF.attribute(block)
    assert all(got[m] and got[m]["dominant"] for m in got)
    path = tmp_path / "block.json"
    path.write_text(json.dumps(block))
    code, out, _ = same_output([path], capsys)
    assert code == 0 and "no timeline data" not in out


def test_gap_block_formula_on_fixed_rates():
    summary = {"phase_share": {"host_wait": 0.5, "h2d": 0.1,
                               "dispatch": 0.3, "device_wait": 0.1},
               "phase_ms": {}, "steps": 8, "examples": 512,
               "dispatches": 1, "fuse_steps": 8.0}
    block = attribute_gap.gap_block({
        "two_tower": dict(device=1000.04, feeder=5e6, pipeline=750.0,
                          timeline=summary),
        "dlrm": dict(device=2000.0, feeder=1e6, pipeline=2100.0,
                     timeline=summary)})
    era = block["tpu_era"]
    assert era["two_tower_examples_per_sec_per_chip"] == 1000.0
    assert era["two_tower_pipeline_gap_pct"] == 25.0
    assert era["dlrm_pipeline_gap_pct"] == -5.0
    attr = attribute_gap.attribute(block)
    assert attr["two_tower"]["dominant"] == "host_wait"
    assert attr["two_tower"]["dominant_share"] == 0.5


def test_slope_rate_is_the_median_slope():
    times = iter([9.0, 9.0,             # the untimed warm runs
                  1.5, 0.5, 3.0, 0.5, 2.5, 0.5])
    rate = attribute_gap.slope_rate(lambda n: next(times), 100)
    # slopes (1.5-0.5)/50, (3-0.5)/50, (2.5-0.5)/50: the median is 0.04
    assert rate == round(100 / 0.04, 1)
