"""One-command model-quality verdict from a ``/quality.json`` document.

Port of the reference's ``tools/attribute_quality.py``, with the same
verdicts on the same inputs.  Feed it a live engine server (or
dashboard) base URL, or a saved document, and it prints the dominant
quality issue plus the recommended response:

Usage::

    # against a live engine server
    python -m predictionio_tpu_torch.tools.attribute_quality \
        http://127.0.0.1:8000
    # against a saved /quality.json document
    python -m predictionio_tpu_torch.tools.attribute_quality quality.json

Verdict order (worst wins): shadow divergence → recall regression (with
the specific knob named from the miss-attribution gauges: cell-miss
dominant → widen ``PIO_IVF_NPROBE``, shortlist-saturation dominant →
raise ``PIO_PQ_RERANK``, neither → rebuild the index) → drift tripped →
reporting-only scorecard → falling online hit-rate → diversity collapse
→ insufficient samples (cold app: pass-through, NEVER a gate) → healthy.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


def load_quality(source: str) -> Dict[str, Any]:
    if source.startswith(("http://", "https://")):
        from urllib.request import urlopen

        url = source.rstrip("/")
        if not url.endswith("/quality.json"):
            url += "/quality.json"
        with urlopen(url, timeout=10) as resp:
            doc = json.loads(resp.read())
    else:
        with open(source, encoding="utf-8") as f:
            doc = json.load(f)
    # a dashboard's /quality.json (live or saved) wraps the fleet-merged
    # doc — unwrap it on both paths
    if "merged" in doc and isinstance(doc.get("merged"), dict):
        return doc["merged"]
    return doc


def _fmt(v: Optional[float], nd: int = 3) -> str:
    return "-" if v is None else f"{v:.{nd}f}"


def verdict_lines(doc: Dict[str, Any]) -> List[str]:
    """The printed report (pure function — unit-tested)."""
    if not doc.get("enabled", False):
        return ["quality layer disabled (PIO_QUALITY=off) — no verdict; "
                "enable it to observe what this server serves, not just "
                "how fast"]
    out: List[str] = []
    drift = doc.get("drift") or {}
    shadow = doc.get("shadow") or {}
    feedback = doc.get("feedback") or {}
    diversity = doc.get("diversity") or {}
    gate = doc.get("gate") or {}
    out.append(f"generation {doc.get('generation')} — verdict: "
               f"{doc.get('verdict')}"
               + (" [GATE=ROLLBACK]" if gate.get("rollback") else ""))
    psi = drift.get("psi") or {}
    out.append(f"  drift: psi fast={_fmt(psi.get('fast'))} "
               f"slow={_fmt(psi.get('slow'))} "
               f"(threshold {drift.get('threshold')}, "
               f"n={drift.get('nFast', 0)}/{drift.get('nSlow', 0)})")
    out.append(f"  shadow: overlap mean={_fmt(shadow.get('overlapMean'), 2)}"
               f" p10={_fmt(shadow.get('overlapP10'), 2)} over "
               f"{shadow.get('scored', 0)} pairs"
               + (" (no active canary)" if not shadow.get("active")
                  else ""))
    recall = doc.get("recall") or {}
    r_rungs = recall.get("rungs") or {}
    if recall.get("enabled") and r_rungs:
        rows = ", ".join(
            f"{rung}: {_fmt(row.get('recallFast'))}/"
            f"{_fmt(row.get('baseline'))}"
            + ("!" if row.get("tripped") else "")
            for rung, row in sorted(r_rungs.items()))
        out.append(f"  recall@{recall.get('k')}: {rows} "
                   f"(live/baseline per rung; sample "
                   f"{recall.get('sample')})")
    gens = feedback.get("generations") or {}

    def _gen_key(kv):
        # keys are STRINGS of generation numbers: "10" must sort after
        # "9", or old-vs-new comparisons silently invert
        try:
            return (0, int(kv[0]))
        except (TypeError, ValueError):
            return (1, 0)

    if gens:
        rows = ", ".join(
            f"g{g}: {row.get('hitRate')} ({row.get('hits')}h/"
            f"{row.get('misses')}m)"
            for g, row in sorted(gens.items(), key=_gen_key))
        out.append(f"  online hit-rate: {rows}")

    # -- the dominant issue + attack ---------------------------------------
    if shadow.get("divergent"):
        out.append("DOMINANT: shadow divergence — the canary generation "
                   "ranks differently from the generation it replaces "
                   f"(overlap {_fmt(shadow.get('overlapMean'), 2)} < "
                   f"{shadow.get('minOverlap')}).")
        out.append("ATTACK: let the gate roll back (it will, with "
                   "PIO_QUALITY_GATE=on); inspect the refresh window — a "
                   "warm-start over a skewed delta is the usual cause "
                   "(pio_refresh_runs_total{result}).")
    elif recall.get("tripped") and not recall.get("reportingOnly"):
        bad = [(rung, row) for rung, row in sorted(r_rungs.items())
               if row.get("tripped")]
        rungs_s = ", ".join(
            f"{rung} {_fmt(row.get('recallFast'))} vs baseline "
            f"{_fmt(row.get('baseline'))}" for rung, row in bad)
        out.append("DOMINANT: retrieval recall regression — the "
                   "approximate rung(s) no longer return the true top-k "
                   f"this generation's own scorecard promises ({rungs_s}"
                   f", tolerance {recall.get('tolerance')}).")
        # The miss-attribution gauges name the knob: a missed true item
        # whose cell was probed fell off the PQ rerank shortlist; one
        # whose cell was NOT probed never entered the race.
        cell = max((row.get("cellMiss") or 0.0) for _, row in bad)
        shortlist = max((row.get("shortlistSaturation") or 0.0)
                        for _, row in bad)
        if cell > shortlist and cell > 0.05:
            out.append(f"ATTACK: cell-miss dominant ({cell:.0%} of true "
                       f"top-k in unprobed cells) — widen "
                       f"PIO_IVF_NPROBE; the probe ring is too narrow "
                       f"for this corpus.")
        elif shortlist > cell and shortlist > 0.05:
            out.append(f"ATTACK: shortlist saturation dominant "
                       f"({shortlist:.0%} of true top-k probed but "
                       f"outside the rerank shortlist) — raise "
                       f"PIO_PQ_RERANK; quantization error is pushing "
                       f"true items below the cut.")
        else:
            out.append("ATTACK: neither cell-miss nor shortlist "
                       "saturation dominates — the index/codes "
                       "themselves no longer fit the corpus (skewed "
                       "delta-refresh is the usual cause); rebuild by "
                       "retraining.  Inside a canary window the gate "
                       "rolls back first.")
    elif drift.get("tripped"):
        out.append("DOMINANT: score-distribution drift — serving scores "
                   "no longer match the generation's own training-time "
                   "scorecard on both windows.")
        out.append("ATTACK: if inside a canary window the gate rolls "
                   "back; otherwise retrain (the model is stale for "
                   "current traffic) and check fold-in share "
                   "(pio_quality_fold_in_share) — heavy fold-in traffic "
                   "scores through a different path than the baseline.")
    elif drift.get("reportingOnly"):
        out.append(f"DOMINANT: no trusted scorecard "
                   f"({drift.get('reason')}) — drift detection is "
                   "reporting-only and the gate can only act on shadow "
                   "divergence.")
        out.append("ATTACK: retrain with this build (scorecards ride the "
                   "wrapper pickle); a fingerprint_mismatch means the "
                   "corpus was mutated after training — find who.")
    else:
        hit_rates = [row.get("hitRate") for _, row in
                     sorted(gens.items(), key=_gen_key)
                     if row.get("hitRate") is not None]
        top_share = diversity.get("topItemShare")
        if len(hit_rates) >= 2 and hit_rates[-1] < 0.5 * hit_rates[0]:
            out.append("DOMINANT: online hit-rate collapsed across "
                       f"generations ({hit_rates[0]} → {hit_rates[-1]}) "
                       "with score distributions healthy — the model "
                       "drifted from USERS, not from itself.")
            out.append("ATTACK: shorten the refresh cadence or switch "
                       "the daemon to trigger mode "
                       "(PIO_REFRESH_TRIGGER_STALENESS_S / "
                       "_DELTA_COUNT).")
        elif top_share is not None and top_share > 0.5:
            out.append(f"DOMINANT: diversity collapse — one item takes "
                       f"{top_share:.0%} of served slots.")
            out.append("ATTACK: inspect the last warm-start (a collapsed "
                       "embedding table serves one popular row); "
                       "PIO_REFRESH_MAX_DELTA_FRACTION gates how much "
                       "delta a continuation may absorb.")
        elif doc.get("verdict") == "insufficient":
            out.append("DOMINANT: not enough sampled predictions for a "
                       "verdict (cold app) — pass-through by design; "
                       "the gate never blocks on silence.")
            out.append("ATTACK: none needed; raise PIO_QUALITY_SAMPLE "
                       "if this server has traffic but samples too "
                       "thinly.")
        else:
            out.append("DOMINANT: nothing — score distribution, shadow "
                       "overlap, and feedback all healthy.")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("source",
                    help="engine-server base URL, or a saved "
                         "/quality.json path")
    args = ap.parse_args(argv)
    try:
        doc = load_quality(args.source)
    except Exception as e:  # noqa: BLE001 - CLI surface
        print(f"[error] cannot load {args.source}: {e}", file=sys.stderr)
        return 1
    for line in verdict_lines(doc):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
