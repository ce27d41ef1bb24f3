"""Attribute the feeder-vs-realized pipeline gap to its dominant component.

Port of the reference's ``tools/attribute_gap.py``, with the same
attribution, residual and compare on the same inputs, and the same text.
The training loops decompose every dispatch into host_wait / h2d /
dispatch / device_wait (``obs.pipeline`` →
``obs.runtime.StepTimeline``).  This tool reads a round's four rates per
model plus that timeline and prints, per model, the dominant gap
component with its share of step time and the recommended attack.

Usage::

    python -m predictionio_tpu_torch.tools.attribute_gap round.json
    # or against a live process's ring:
    python -m predictionio_tpu_torch.tools.attribute_gap round.json \\
        --timeline http://127.0.0.1:7072/timeline.json
    # before/after a change — per-model gap delta + dominant shift:
    python -m predictionio_tpu_torch.tools.attribute_gap \\
        --compare BENCH_r06.json BENCH_r07.json

The round may be the raw one-line JSON of a bench run, any JSON object
holding its ``tpu_era`` block (the key keeps the reference's name, so
either package's rounds read the same), or a round capture whose
``tail`` holds the bench stdout; ``--timeline`` overrides the embedded
``timeline`` block with a file or a ``/timeline.json`` URL.

:func:`gap_block` writes that input from the port's own runs:
:func:`slope_rate` times a model's fused window over device-resident
batches (the device rate), :func:`feeder_rate` one pass of the native
feeder (the feeder rate), and the caller's timed feeder-in-the-loop
train gives the pipeline rate and its :class:`~predictionio_tpu_torch.
obs.runtime.StepTimeline` summary.  ``chip_smoke.py`` does so on the
card for both models and feeds the block to :func:`attribute`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable, Dict, Optional

MODELS = ("two_tower", "dlrm")

# Component → the attack the next performance change should mount.
ATTACKS = {
    "host_wait": "feeder threads / parallel batch assembly "
                 "(the host cannot produce batches fast enough)",
    "h2d": "pinned buffers / double buffering "
           "(stage batch N+1 while step N runs)",
    "dispatch": "step fusion (PIO_FUSE_STEPS / pio train --fuse-steps "
                "auto) or a larger batch size (the step-call wall — on "
                "synchronous-dispatch backends the execution itself — "
                "dominates)",
    "device_wait": "step fusion (PIO_FUSE_STEPS / pio train --fuse-steps "
                   "auto) or a larger batch size "
                   "(the device step itself is the bottleneck)",
}

# dispatch/device_wait with fusion ALREADY active (K>1): re-recommending
# fusion would chase the component that is now mostly honest device
# execution — the remaining levers are batch width and memory headroom.
ATTACK_DEVICE_WAIT_FUSED = (
    "batch-size growth (--batch-autoscale) after an HBM-headroom check "
    "(pio_device_mem_peak_bytes vs bytes_limit) — fusion depth K>1 "
    "already amortizes dispatch, the residual device time is mostly "
    "honest execution")

WALL_PHASES = ("host_wait", "h2d", "dispatch", "device_wait")


def load_json(path: str) -> Dict[str, Any]:
    if path == "-":
        return _unwrap(json.load(sys.stdin))
    if path.startswith(("http://", "https://")):
        from urllib.request import urlopen

        with urlopen(path, timeout=10) as resp:
            return _unwrap(json.load(resp))
    with open(path) as f:
        text = f.read()
    try:
        return _unwrap(json.loads(text))
    except json.JSONDecodeError:
        # bench logs sometimes carry stray lines around the JSON object;
        # take the last parseable line (bench.py prints exactly one)
        doc = _last_json_line(text)
        if doc is None:
            raise
        return _unwrap(doc)


def _last_json_line(text: str) -> Optional[Dict[str, Any]]:
    """The last line of ``text`` that parses as a JSON object, if any."""
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None


def _unwrap(doc: Any) -> Dict[str, Any]:
    """Committed BENCH_r*.json rounds are captures whose ``tail``
    holds the bench stdout — reach through so ``--compare BENCH_r05.json
    BENCH_r06.json`` works on the artifacts as committed.  Tails may be
    truncated mid-object (a capture keeps only the last bytes), so fall
    back to brace-scanning the blocks this tool actually reads."""
    if not (isinstance(doc, dict) and "tpu_era" not in doc
            and isinstance(doc.get("tail"), str)):
        return doc
    tail = doc["tail"]
    inner = _last_json_line(tail)
    if inner is not None:
        return inner
    rescued = {k: v for k in ("tpu_era", "timeline")
               if (v := _extract_obj(tail, k)) is not None}
    return rescued if rescued else doc


def _extract_obj(text: str, key: str) -> Optional[Dict[str, Any]]:
    """Parse the balanced ``{...}`` following ``"key":`` in raw text."""
    i = text.find(f'"{key}"')
    if i < 0:
        return None
    i = text.find("{", i)
    if i < 0:
        return None
    depth = 0
    in_str = esc = False
    for j in range(i, len(text)):
        ch = text[j]
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
            if depth == 0:
                try:
                    return json.loads(text[i:j + 1])
                except json.JSONDecodeError:
                    return None
    return None


def _timeline_summaries(doc: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Normalize either bench.py's embedded ``timeline`` block or a
    server ``/timeline.json`` payload to {model: summary}."""
    if "models" in doc and isinstance(doc["models"], dict):
        return doc["models"]  # /timeline.json shape
    return {k: v for k, v in doc.items() if isinstance(v, dict)}


def attribute(bench: Dict[str, Any],
              timeline: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Compute the attribution; returns {model: {...}} (None entries for
    models with no usable data)."""
    tpu_era = bench.get("tpu_era", bench)
    summaries = _timeline_summaries(
        timeline if timeline is not None else bench.get("timeline", {}))
    out: Dict[str, Any] = {}
    for model in MODELS:
        gap = tpu_era.get(f"{model}_pipeline_gap_pct")
        feeder = tpu_era.get(f"{model}_feeder_examples_per_sec")
        pipe = tpu_era.get(f"{model}_pipeline_examples_per_sec")
        dev = tpu_era.get(f"{model}_examples_per_sec_per_chip")
        summary = summaries.get(model) or {}
        shares = {p: float(summary.get("phase_share", {}).get(p, 0.0))
                  for p in WALL_PHASES}
        if not any(shares.values()):
            out[model] = None
            continue
        dominant = max(shares, key=lambda p: shares[p])
        # Fusion depth: rounds from before step fusion carry no
        # fuse_steps — one record was one step, K=1.
        fuse = float(summary.get("fuse_steps") or 1.0)
        attack = (ATTACK_DEVICE_WAIT_FUSED
                  if dominant in ("device_wait", "dispatch") and fuse > 1
                  else ATTACKS[dominant])
        out[model] = {
            "gap_pct": gap,
            "feeder_examples_per_sec": feeder,
            "pipeline_examples_per_sec": pipe,
            "device_examples_per_sec": dev,
            "steps": summary.get("steps"),
            "dispatches": summary.get("dispatches"),
            "fuse_steps": fuse,
            "phase_share": shares,
            "phase_ms": summary.get("phase_ms", {}),
            "dominant": dominant,
            "dominant_share": shares[dominant],
            "attack": attack,
            "residual": _residual(summary, dev),
        }
    return out


def _residual(summary: Dict[str, Any], dev: Any) -> Optional[Dict[str, Any]]:
    """Decompose the GAP itself, not the wall: subtract the estimated
    pure device-execution time (examples / device ceiling) from
    device_wait, leaving ``device_excess`` — the dispatch/sync overhead
    step fusion attacks.  Pre-fusion rounds showed device_wait at ~99%
    of the wall even when most of it was honest execution; this view
    says how much of the residual is actually attackable."""
    steps = summary.get("steps")
    examples = summary.get("examples")
    phase_ms = summary.get("phase_ms", {})
    if not (isinstance(dev, (int, float)) and dev > 0 and steps
            and examples):
        return None
    exec_ms_per_step = (examples / steps) / dev * 1e3
    per_step = {p: float(phase_ms.get(p, 0.0)) / steps for p in WALL_PHASES}
    comps = {
        "host_wait": per_step["host_wait"],
        "h2d": per_step["h2d"],
        # dispatch + device_wait together hold the device-side wall (a
        # synchronous-dispatch backend bills execution to the former, an
        # async one to the latter); what exceeds the estimated pure
        # execution is the attackable overhead.
        "device_excess": max(per_step["dispatch"] + per_step["device_wait"]
                             - exec_ms_per_step, 0.0),
    }
    total = sum(comps.values())
    if total <= 0:
        return None
    dominant = max(comps, key=lambda p: comps[p])
    return {
        "exec_ms_per_step_est": round(exec_ms_per_step, 3),
        "ms_per_step": {p: round(v, 3) for p, v in comps.items()},
        "share": {p: round(v / total, 4) for p, v in comps.items()},
        "dominant": dominant,
        "dominant_share": round(comps[dominant] / total, 4),
    }


def _round_stats(bench: Dict[str, Any], model: str,
                 attr: Optional[Dict]) -> Optional[Dict]:
    """One model's comparable numbers from a round: gap/rates straight
    from ``tpu_era`` (available even for rounds that predate the step
    timeline), the dominant-component attribution when the round has
    one."""
    tpu_era = bench.get("tpu_era", bench)
    gap = tpu_era.get(f"{model}_pipeline_gap_pct")
    pipe = tpu_era.get(f"{model}_pipeline_examples_per_sec")
    if gap is None and pipe is None and attr is None:
        return None
    return {
        "gap_pct": gap,
        "pipeline_examples_per_sec": pipe,
        "feeder_examples_per_sec":
            tpu_era.get(f"{model}_feeder_examples_per_sec"),
        "attribution": attr,
    }


def compare(old_bench: Dict[str, Any],
            new_bench: Dict[str, Any]) -> Dict[str, Any]:
    """Per-model before/after of two rounds: gap delta + dominant shift.

    The one-command check for a performance change: did the gap
    close, and did the bottleneck move to the next component?
    """
    old_attr = attribute(old_bench)
    new_attr = attribute(new_bench)
    out: Dict[str, Any] = {}
    for model in MODELS:
        o = _round_stats(old_bench, model, old_attr.get(model))
        n = _round_stats(new_bench, model, new_attr.get(model))
        if o is None and n is None:
            out[model] = None
            continue
        entry: Dict[str, Any] = {"old": o, "new": n}
        if o and n:
            og, ng = o.get("gap_pct"), n.get("gap_pct")
            if isinstance(og, (int, float)) and isinstance(ng, (int, float)):
                entry["gap_delta_pct"] = round(ng - og, 1)
            op, np_ = (o.get("pipeline_examples_per_sec"),
                       n.get("pipeline_examples_per_sec"))
            if isinstance(op, (int, float)) and isinstance(np_, (int, float)) \
                    and op > 0:
                entry["realized_speedup"] = round(np_ / op, 3)
            oa, na = o.get("attribution"), n.get("attribution")
            if oa and na:
                entry["dominant_shift"] = (oa["dominant"], na["dominant"])
                entry["fuse_steps_shift"] = (oa.get("fuse_steps", 1.0),
                                             na.get("fuse_steps", 1.0))
        out[model] = entry
    return out


def render_compare(result: Dict[str, Any]) -> str:
    lines = []
    for model in MODELS:
        r = result.get(model)
        if r is None:
            lines.append(f"{model}: no data in either round")
            continue
        o, n = r.get("old"), r.get("new")
        if not (o and n):
            which = "old" if not o else "new"
            lines.append(f"{model}: no usable data in the {which} round")
            continue

        def g(e):
            v = e.get("gap_pct")
            return f"{v:.1f}%" if isinstance(v, (int, float)) else "?"

        delta = r.get("gap_delta_pct")
        arrow = (f" ({delta:+.1f} pts)"
                 if isinstance(delta, (int, float)) else "")
        lines.append(f"{model}: pipeline gap {g(o)} -> {g(n)}{arrow}")
        lines.append(
            f"  realized: {_fmt_rate(o['pipeline_examples_per_sec'])} -> "
            f"{_fmt_rate(n['pipeline_examples_per_sec'])}"
            + (f" ({r['realized_speedup']:.2f}x)"
               if "realized_speedup" in r else ""))
        oa, na = o.get("attribution"), n.get("attribution")
        if "dominant_shift" in r:
            od, nd = r["dominant_shift"]
            if od == nd:
                lines.append(
                    f"  dominant component: {od} "
                    f"({oa['dominant_share'] * 100:.1f}% -> "
                    f"{na['dominant_share'] * 100:.1f}% of step wall)")
            else:
                lines.append(
                    f"  dominant component shifted: {od} "
                    f"({oa['dominant_share'] * 100:.1f}%) -> {nd} "
                    f"({na['dominant_share'] * 100:.1f}%)")
        elif na:
            lines.append(
                f"  dominant component (new round): {na['dominant']} "
                f"({na['dominant_share'] * 100:.1f}% of step wall; "
                "old round has no timeline)")
        if "fuse_steps_shift" in r:
            ok_, nk = r["fuse_steps_shift"]
            if ok_ != nk:
                lines.append(
                    f"  fusion depth: K={ok_:.0f} -> K={nk:.0f}")
        if na and na.get("residual"):
            lines.append("  residual per step (new round, vs device "
                         "ceiling): " + _fmt_residual(na["residual"]))
        if na:
            lines.append(f"  next attack: {na['attack']}")
    return "\n".join(lines)


def _fmt_residual(res: Dict[str, Any]) -> str:
    return " | ".join(
        f"{p} {res['share'][p] * 100:.1f}%"
        for p in ("host_wait", "h2d", "device_excess"))


def _fmt_rate(v: Any) -> str:
    return f"{v:,.0f} ex/s" if isinstance(v, (int, float)) else "?"


def render(result: Dict[str, Any]) -> str:
    lines = []
    for model in MODELS:
        r = result.get(model)
        if r is None:
            lines.append(f"{model}: no timeline data (run bench.py, or "
                         "point --timeline at a training process's "
                         "/timeline.json)")
            continue
        gap = r["gap_pct"]
        head = f"{model}: pipeline gap " + (
            f"{gap:.1f}%" if isinstance(gap, (int, float)) else "?")
        if r["feeder_examples_per_sec"] or r["pipeline_examples_per_sec"]:
            head += (f" (feeder {_fmt_rate(r['feeder_examples_per_sec'])}"
                     f" -> realized "
                     f"{_fmt_rate(r['pipeline_examples_per_sec'])}"
                     f", device ceiling "
                     f"{_fmt_rate(r['device_examples_per_sec'])})")
        lines.append(head)
        shares = r["phase_share"]
        lines.append("  step-time decomposition: " + " | ".join(
            f"{p} {shares[p] * 100:.1f}%" for p in WALL_PHASES))
        lines.append(f"  dominant: {r['dominant']} "
                     f"({r['dominant_share'] * 100:.1f}% of step wall, "
                     f"over {r['steps']} steps)")
        if r.get("fuse_steps", 1) > 1:
            lines.append(
                f"  fusion depth: K={r['fuse_steps']:.0f} "
                f"({r['dispatches']} dispatches over {r['steps']} steps)")
        if r.get("residual"):
            lines.append("  residual per step (vs device ceiling): "
                         + _fmt_residual(r["residual"]))
        lines.append(f"  attack: {r['attack']}")
    return "\n".join(lines)


# -- the round's input, from the port's own runs -----------------------------

SLOPE_STEPS = (2, 52)   # the slope pair: windows of 2 and of 52 steps
N_STAGE = 8             # distinct device-resident batches the slope cycles


def _barrier(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def slope_rate(run: Callable[[int], float], batch_size: int) -> float:
    """Examples/s of the device step by the slope method: ``run(n)``
    times one fused window of ``n`` steps over device-resident batches
    (staged before its timer) and returns seconds.  Both window lengths
    run once untimed, then the median of three ``(run(52) - run(2)) /
    50`` pairs is the time of one step: what a window costs beyond its
    fixed part cancels."""
    lo, hi = SLOPE_STEPS
    run(lo)
    run(hi)
    pairs = sorted((run(hi) - run(lo)) / (hi - lo) for _ in range(3))
    return round(batch_size / max(pairs[1], 1e-9), 1)


def two_tower_device_rate(state, cfg, user_ids, item_ids, device) -> float:
    """:func:`slope_rate` of ``two_tower.train_steps_fused`` from
    ``state``: the first ``N_STAGE`` batches of the ids staged on
    ``device``, each window cycling through them, weights 1."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import two_tower as tt

    bs = cfg.batch_size
    rows = N_STAGE * bs

    def staged(ids):
        return torch.as_tensor(np.asarray(ids[:rows], np.int32).reshape(
            N_STAGE, bs), device=device)

    u, i = staged(user_ids), staged(item_ids)
    w = torch.ones((N_STAGE, bs), dtype=torch.float32, device=device)

    def run(n: int) -> float:
        idx = torch.arange(n, device=device) % N_STAGE
        args = (u[idx], i[idx], w[idx])
        _barrier(device)
        t0 = time.perf_counter()
        tt.train_steps_fused(state, *args, cfg)
        _barrier(device)
        return time.perf_counter() - t0

    return slope_rate(run, bs)


def dlrm_device_rate(state, cfg, dense, cat, labels, device) -> float:
    """:func:`slope_rate` of ``dlrm.train_steps_fused`` from ``state``:
    the first ``N_STAGE`` batches staged on ``device`` (``cat`` per
    field, the offsets applied here), weights 1."""
    import numpy as np
    import torch

    from predictionio_tpu_torch.models import dlrm as dl

    bs = cfg.batch_size
    rows = N_STAGE * bs

    def staged(x, dtype):
        x = np.asarray(x[:rows], dtype)
        return torch.as_tensor(x.reshape(N_STAGE, bs, *x.shape[1:]),
                               device=device)

    d = staged(dense, np.float32)
    c = staged(np.asarray(cat[:rows], np.int64) + cfg.offsets[None, :],
               np.int32)
    y = staged(labels, np.float32)
    w = torch.ones((N_STAGE, bs), dtype=torch.float32, device=device)

    def run(n: int) -> float:
        idx = torch.arange(n, device=device) % N_STAGE
        args = (d[idx], c[idx], y[idx], w[idx])
        _barrier(device)
        t0 = time.perf_counter()
        dl.train_steps_fused(state, *args, cfg)
        _barrier(device)
        return time.perf_counter() - t0

    return slope_rate(run, bs)


def feeder_rate(batch_size: int, **cache_columns) -> float:
    """Examples/s of one pass of the native feeder, without training,
    over a cache of ``cache_columns`` (``native.feeder.write_cache``'s
    keywords; written before the timer): ``next_batch`` for a user/item
    cache, ``next_batch_cats`` for one of categorical columns."""
    import tempfile

    from predictionio_tpu_torch.native.feeder import EventFeeder, write_cache

    with tempfile.TemporaryDirectory(prefix="pio_gap_feed_") as d:
        cache = write_cache(f"{d}/c.piof", **cache_columns)
        with EventFeeder(cache, batch_size, seed=1) as fd:
            step = (fd.next_batch_cats if "cats" in cache_columns
                    else fd.next_batch)
            n, t0 = 0, time.perf_counter()
            b = step()
            while b is not None:
                n += len(b[0])
                b = step()
            return round(n / (time.perf_counter() - t0), 1)


def gap_block(models: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The round document :func:`attribute` reads, from measured rates.

    ``models`` maps each of :data:`MODELS` to ``{"device": ex/s,
    "feeder": ex/s, "pipeline": ex/s, "timeline": summary}``: the
    :func:`slope_rate` ceiling, the :func:`feeder_rate`, the rate of a
    feeder-in-the-loop train and that train's ``StepTimeline.summary``.
    Returns ``{"tpu_era": {...}, "timeline": {"models": {...}}}``: the
    flat block of the reference's bench rounds (rates rounded to 0.1,
    the gap ``100·(1 − pipeline/device)`` of the rounded rates) and the
    summaries in ``/timeline.json``'s shape."""
    era: Dict[str, Any] = {}
    for model in MODELS:
        m = models[model]
        dev, pipe = round(m["device"], 1), round(m["pipeline"], 1)
        era[f"{model}_examples_per_sec_per_chip"] = dev
        era[f"{model}_feeder_examples_per_sec"] = round(m["feeder"], 1)
        era[f"{model}_pipeline_examples_per_sec"] = pipe
        era[f"{model}_pipeline_gap_pct"] = (
            round(100 * (1 - pipe / dev), 1) if dev else None)
    return {"tpu_era": era,
            "timeline": {"models": {m: models[m]["timeline"]
                                    for m in MODELS}}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="attribute the feeder-vs-realized pipeline gap")
    ap.add_argument("bench", nargs="?", default="-",
                    help="bench.py round artifact (JSON file, '-' stdin)")
    ap.add_argument("--compare", nargs=2, default=None,
                    metavar=("OLD", "NEW"),
                    help="compare two rounds: per-model gap delta and "
                         "dominant-component shift (ignores the "
                         "positional bench argument)")
    ap.add_argument("--timeline", default=None, metavar="FILE|URL",
                    help="step-timeline source overriding the bench "
                         "artifact's embedded block (a /timeline.json "
                         "URL or a saved payload)")
    ap.add_argument("--json", action="store_true",
                    help="emit the attribution as JSON instead of text")
    args = ap.parse_args(argv)

    if args.compare:
        if args.timeline:
            ap.error("--timeline cannot be combined with --compare "
                     "(each round's timeline comes from its own artifact)")
        result = compare(load_json(args.compare[0]),
                         load_json(args.compare[1]))
        if args.json:
            print(json.dumps(result, indent=2))
        else:
            print(render_compare(result))
        return 0 if any(
            isinstance(result.get(m), dict)
            and result[m].get("old") and result[m].get("new")
            for m in MODELS) else 1

    bench = load_json(args.bench)
    timeline = load_json(args.timeline) if args.timeline else None
    result = attribute(bench, timeline)
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(render(result))
    # Non-zero when NOTHING could be attributed: a wired-up bench must
    # never silently print two "no data" stanzas and exit 0.
    return 0 if any(result.get(m) for m in MODELS) else 1


if __name__ == "__main__":
    sys.exit(main())
