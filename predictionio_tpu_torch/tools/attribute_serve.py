"""Attribute served /queries.json latency to its dominant pipeline stage.

Port of the reference's ``tools/attribute_serve.py``, with the same
verdicts on the same inputs.  A request crosses admission queue → batch
window → bind → dispatch (retrieval inside) → serialize → shed check,
and every stage lands in the ``pio_serve_stage_ms{stage}`` histogram
family plus the optional ``PIO_REQUEST_LOG`` wide-event JSONL.  This
tool reads either and prints, per stage, its share of the served wall —
and the recommended attack for the dominant one.  It reads only those
outputs: no card and no model.

Usage::

    # against a live engine server's exposition
    python -m predictionio_tpu_torch.tools.attribute_serve \
        http://127.0.0.1:8000/metrics
    # against a saved exposition
    python -m predictionio_tpu_torch.tools.attribute_serve metrics.txt
    # against a PIO_REQUEST_LOG wide-event file (per-request p50/p95,
    # plus the stage-sum vs server-total reconciliation)
    python -m predictionio_tpu_torch.tools.attribute_serve requests.jsonl

``retrieval`` is a sub-stage of ``dispatch`` and is excluded from the
wall-share denominator; it is reported indented under dispatch with its
own attack when IT dominates the dispatch.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Any, Dict, List, Optional

STAGES = ("ingress", "queue_wait", "batch_wait", "bind", "cache",
          "dispatch", "resume", "retrieval", "serialize", "shed_check")
# Additive stages: their sum ≈ the request's total server wall.
WALL_STAGES = ("ingress", "queue_wait", "batch_wait", "bind", "cache",
               "dispatch", "resume", "serialize", "shed_check")
# The subset the X-PIO-Server-Ms attestation CONTAINS (the header is
# read before the response is written, so serialize lies outside it).
ATTESTED_STAGES = ("ingress", "queue_wait", "batch_wait", "bind", "cache",
                   "dispatch", "resume", "shed_check")

ATTACKS = {
    "ingress": "transport receipt → bind (body read, trace setup, "
               "routing) — per-request handler-thread work; if it "
               "dominates, payloads are huge or handler threads are "
               "starved for the GIL",
    "resume": "post-dispatch thread wake-up — GIL/thread contention as "
              "handler threads resume; fewer concurrent clients per "
              "instance (scale out) or larger batches (fewer wake-up "
              "herds) reduce it",
    "queue_wait": "offered load > capacity — scale out (the /ready SLO "
                  "signal + pio_slo_burn_rate say when the LB should "
                  "rotate instances); raising PIO_QUEUE_DEPTH only "
                  "trades 429s for queueing latency",
    "batch_wait": "the gather window is too wide for this traffic — "
                  "lower PIO_BATCH_P99_TARGET_MS (the autotuner shrinks "
                  "the window to meet it) or PIO_BATCH_WINDOW_MS "
                  "directly; a lone-client stream should already skip "
                  "the window",
    "bind": "query binding — simplify the query_class schema or trim "
            "payload size (bind runs per-request on the handler thread)",
    "cache": "result-cache canonicalization + lookup — sub-millisecond "
             "by design; if it dominates, the traffic is hitting (good: "
             "queue/dispatch are gone from those requests) or queries "
             "are huge (canonicalization is O(payload)); check "
             "pio_result_cache_hit_rate before reading further rows",
    "dispatch": "model execution — grow PIO_BATCH_MAX to amortize more "
                "requests per dispatch (check HBM headroom first), or "
                "attack the model itself; if retrieval dominates the "
                "dispatch (below), attack retrieval instead",
    "retrieval": "retrieval rung — escalate: IVF at train time "
                 "(PIO_IVF=on) or mesh-sharded exact "
                 "(PIO_SERVE_SHARD_ABOVE); pio_retrieval_ms{rung} and "
                 "candidates-per-query name the rung to fix",
    "serialize": "result serialization — trim result size (num / "
                 "payload fields); serialization runs per-request on "
                 "the response path",
    "shed_check": "transport bookkeeping — negligible by design; if it "
                  "dominates, traffic is near-zero or stages are "
                  "missing from the capture",
}

_HIST_RE = re.compile(
    r'^pio_serve_stage_ms_(sum|count)\{stage="([^"]+)"\}\s+(\S+)')


def _read_source(src: str) -> str:
    if src.startswith(("http://", "https://")):
        from urllib.request import urlopen

        url = src if "/metrics" in src else src.rstrip("/") + "/metrics"
        with urlopen(url, timeout=10) as resp:
            return resp.read().decode()
    if src == "-":
        return sys.stdin.read()
    with open(src, encoding="utf-8") as f:
        return f.read()


def parse_metrics(text: str) -> Dict[str, Dict[str, float]]:
    """{stage: {"sum": ms, "count": n}} from a text exposition."""
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.split(" # ", 1)[0].strip()  # drop exemplar suffixes
        m = _HIST_RE.match(line)
        if not m:
            continue
        kind, stage, raw = m.groups()
        try:
            v = float(raw)
        except ValueError:
            continue
        out.setdefault(stage, {"sum": 0.0, "count": 0.0})[kind] = v
    return out


def parse_request_log(text: str) -> List[Dict[str, Any]]:
    """Wide-event JSONL rows (unparseable lines skipped)."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(doc, dict) and isinstance(doc.get("stages"), dict):
            rows.append(doc)
    return rows


def _percentile(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(int(q * len(s)), len(s) - 1)]


def attribute_metrics(stages: Dict[str, Dict[str, float]]
                      ) -> Optional[Dict[str, Any]]:
    """Mean-ms attribution from the histogram family."""
    means = {}
    for stage in STAGES:
        row = stages.get(stage)
        if row and row.get("count"):
            means[stage] = row["sum"] / row["count"]
    return _attribution(means, {s: stages[s]["count"]
                                for s in means}) if means else None


def attribute_log(rows: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Per-request attribution from the wide-event log, plus the
    stage-sum vs server-total reconciliation."""
    if not rows:
        return None
    per_stage: Dict[str, List[float]] = {}
    sums, totals = [], []
    attested_sums, attested = [], []
    for doc in rows:
        st = doc["stages"]
        for stage, ms in st.items():
            if stage in STAGES:
                per_stage.setdefault(stage, []).append(float(ms))
        wall = sum(float(st.get(s, 0.0)) for s in WALL_STAGES)
        sums.append(wall)
        if isinstance(doc.get("totalMs"), (int, float)):
            totals.append(float(doc["totalMs"]))
        if isinstance(doc.get("serverMs"), (int, float)):
            attested.append(float(doc["serverMs"]))
            attested_sums.append(sum(
                float(st.get(s, 0.0)) for s in ATTESTED_STAGES))
    means = {s: sum(v) / len(v) for s, v in per_stage.items()}
    out = _attribution(means, {s: len(v) for s, v in per_stage.items()})
    out["p50"] = {s: round(_percentile(v, 0.5), 3)
                  for s, v in sorted(per_stage.items())}
    out["p95"] = {s: round(_percentile(v, 0.95), 3)
                  for s, v in sorted(per_stage.items())}
    out["requests"] = len(rows)
    if totals:
        p50_sum = _percentile(sums, 0.5)
        p50_total = _percentile(totals, 0.5)
        out["reconciliation"] = {
            "stage_sum_p50_ms": round(p50_sum, 3),
            "total_p50_ms": round(p50_total, 3),
            "ratio": (round(p50_sum / p50_total, 3) if p50_total else None),
        }
    if attested:
        # The reconciliation: the stages the X-PIO-Server-Ms
        # wall contains, vs that attested wall — within 10% at p50.
        p50_att_sum = _percentile(attested_sums, 0.5)
        p50_att = _percentile(attested, 0.5)
        out.setdefault("reconciliation", {}).update({
            "attested_stage_sum_p50_ms": round(p50_att_sum, 3),
            "server_attested_p50_ms": round(p50_att, 3),
            "attested_ratio": (round(p50_att_sum / p50_att, 3)
                               if p50_att else None),
        })
    return out


def _attribution(means: Dict[str, float],
                 counts: Dict[str, float]) -> Dict[str, Any]:
    wall = {s: m for s, m in means.items() if s in WALL_STAGES}
    total = sum(wall.values())
    shares = {s: (m / total if total else 0.0) for s, m in wall.items()}
    dominant = max(shares, key=lambda s: shares[s]) if shares else None
    out: Dict[str, Any] = {
        "mean_ms": {s: round(m, 3) for s, m in sorted(means.items())},
        "counts": {s: int(c) for s, c in sorted(counts.items())},
        "wall_share": {s: round(v, 4) for s, v in sorted(shares.items())},
        "dominant": dominant,
        "dominant_share": round(shares[dominant], 4) if dominant else None,
        "attack": ATTACKS[dominant] if dominant else None,
    }
    # retrieval ⊂ dispatch: when the sub-stage is most of its parent,
    # the actionable attack is the retrieval one.
    r, d = means.get("retrieval"), means.get("dispatch")
    if r is not None and d:
        out["retrieval_share_of_dispatch"] = round(min(r / d, 1.0), 4)
        if dominant == "dispatch" and r / d >= 0.5:
            out["attack"] = ATTACKS["retrieval"]
            out["attack_reason"] = (
                "retrieval is ≥50% of the dominant dispatch stage")
    return out


def render(result: Dict[str, Any]) -> str:
    lines = []
    n = result.get("requests") or max(result["counts"].values(), default=0)
    lines.append(f"serving waterfall over {n} request(s):")
    for stage in STAGES:
        m = result["mean_ms"].get(stage)
        if m is None:
            continue
        share = result["wall_share"].get(stage)
        suffix = (f"  ({share * 100:5.1f}% of wall)"
                  if share is not None else "   (⊂ dispatch)")
        p50 = result.get("p50", {}).get(stage)
        p = f"  p50 {p50:g}ms" if p50 is not None else ""
        lines.append(f"  {stage:<11} mean {m:8.3f} ms{p}{suffix}")
    if result.get("retrieval_share_of_dispatch") is not None:
        lines.append(
            f"  retrieval is {result['retrieval_share_of_dispatch'] * 100:.1f}%"
            " of the dispatch stage")
    rec = result.get("reconciliation")
    if rec:
        ratio = rec.get("ratio")
        if "stage_sum_p50_ms" in rec:
            lines.append(
                f"  stage-sum p50 {rec['stage_sum_p50_ms']:g} ms vs "
                f"request total p50 {rec['total_p50_ms']:g} ms"
                + (f" (ratio {ratio:.2f})" if ratio is not None else ""))
        aratio = rec.get("attested_ratio")
        if "attested_stage_sum_p50_ms" in rec:
            lines.append(
                f"  attested-stage sum p50 "
                f"{rec['attested_stage_sum_p50_ms']:g} ms vs "
                f"X-PIO-Server-Ms p50 {rec['server_attested_p50_ms']:g} ms"
                + (f" (ratio {aratio:.2f})" if aratio is not None else ""))
    lines.append(f"dominant: {result['dominant']} "
                 f"({(result['dominant_share'] or 0) * 100:.1f}% of wall)")
    lines.append(f"attack: {result['attack']}")
    if result.get("attack_reason"):
        lines.append(f"  ({result['attack_reason']})")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="attribute served latency to its dominant stage")
    ap.add_argument("source",
                    help="a /metrics URL (or server base URL), a saved "
                         "exposition file, a PIO_REQUEST_LOG .jsonl, or "
                         "'-' for stdin")
    ap.add_argument("--json", action="store_true",
                    help="emit the attribution as JSON instead of text")
    args = ap.parse_args(argv)

    text = _read_source(args.source)
    rows = parse_request_log(text)
    if rows:
        result = attribute_log(rows)
    else:
        result = attribute_metrics(parse_metrics(text))
    if result is None:
        print("no pio_serve_stage_ms data (drive /queries.json traffic "
              "first, or point this at PIO_REQUEST_LOG output)",
              file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        print(render(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
