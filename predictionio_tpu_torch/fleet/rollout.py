"""Wave-based generation rollout with whole-fleet rollback.

Port of ``predictionio_tpu/fleet/rollout.py``.

One :class:`RolloutController` drives ONE candidate generation across N
engine-server replicas:

1. **Waves** — instances promote in configurable tranches
   (``1,25%,100%`` by default): one canary instance first, then a
   quarter of the fleet, then everyone.  Each ``POST /reload`` carries
   the target ``engineInstanceId`` (pinned from the first successful
   promotion when not given explicitly), so a newer COMPLETED train
   landing mid-wave can never split the fleet across generations.
2. **Gate** — after each wave the controller bakes for
   ``RolloutConfig.bake_s``, polling the fleet-merged view
   (:class:`~predictionio_tpu_torch.obs.fleet.FleetAggregator`): any
   non-stale instance whose SLO is degraded or whose fast-window burn
   crosses the threshold, or a merged ``/quality.json`` rollback
   verdict, halts the rollout.  One degraded canary protects the other
   N-1 replicas — they never load the candidate.
3. **Halt = whole-fleet rollback** — every already-promoted instance is
   rolled back through ``POST /admin/rollback`` (the instant swap;
   the pre-promotion generation is retained server-side exactly for
   this).  Per-instance 409s and dead instances are recorded and
   skipped — the unwind reports, it never wedges.
4. **Journal** — every step is written ahead to a state file
   (``PIO_ROLLOUT_STATE``, default ``$PIO_HOME/rollout/state.json``), so
   a preempted controller resumes (``pio rollout --resume``: re-verifies
   which instances actually serve the target, then continues the wave)
   or unwinds (``--unwind``) deterministically instead of leaving the
   fleet half-promoted.

Dead instances and per-instance rejections (409 from the staged-reload
validation gate) are **skip-and-report**: the wave completes with what
it has, the skip is in the state file and the summary, and the operator
decides.  A wave where NO instance accepted the candidate fails the
rollout without touching anyone.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import json
import logging
import math
import os
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence
from urllib.request import Request, urlopen

from predictionio_tpu_torch.obs import get_registry, publish_event
from predictionio_tpu_torch.obs.fleet import FleetAggregator

logger = logging.getLogger(__name__)

__all__ = ["RolloutConfig", "RolloutController", "FleetPromoter",
           "parse_waves", "rollout_state_path"]


def _env_f(key: str, default: float) -> float:
    try:
        return float(os.environ.get(key, "") or default)
    except (TypeError, ValueError):
        return default


def rollout_state_path(explicit: Optional[str] = None) -> Path:
    """State-journal location: explicit > ``PIO_ROLLOUT_STATE`` >
    ``$PIO_HOME/rollout/state.json``."""
    cand = explicit or os.environ.get("PIO_ROLLOUT_STATE")
    if cand:
        return Path(cand)
    from predictionio_tpu_torch.config import pio_home

    return pio_home() / "rollout" / "state.json"


def parse_waves(spec: str, n_instances: int) -> List[int]:
    """``"1,25%,100%"`` → cumulative instance counts, e.g. ``[1, 2, 8]``
    for 8 instances.  Absolute integers and percentages mix freely;
    counts are clamped to the fleet, forced strictly nondecreasing, and
    a final 100% wave is appended when the spec stops short — a rollout
    that never reaches the whole fleet is a config typo, not a policy."""
    counts: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            if part.endswith("%"):
                frac = float(part[:-1]) / 100.0
                if not 0.0 < frac <= 1.0:
                    raise ValueError
                n = max(1, math.ceil(frac * n_instances))
            else:
                n = int(part)
                if n < 1:
                    raise ValueError
        except ValueError:
            raise ValueError(
                f"bad wave {part!r} (want a positive count or a "
                f"percentage like 25%)") from None
        counts.append(min(n, n_instances))
    if not counts:
        counts = [n_instances]
    # strictly nondecreasing; drop redundant equal steps
    out: List[int] = []
    for c in counts:
        c = max(c, out[-1] if out else 1)
        if not out or c > out[-1]:
            out.append(c)
    if out[-1] < n_instances:
        out.append(n_instances)
    return out


@dataclasses.dataclass
class RolloutConfig:
    """Rollout knobs; :meth:`from_env` is the production constructor."""

    waves: str = "1,25%,100%"
    bake_s: float = 10.0            # per-wave observation window
    poll_s: float = 1.0             # gate poll cadence inside the bake
    burn_threshold: float = 14.4    # fast-burn trip level (SLO page point)
    reload_timeout_s: float = 300.0  # a reload stages + validates a model
    state_path: Optional[str] = None

    @classmethod
    def from_env(cls, **overrides) -> "RolloutConfig":
        cfg = cls(
            waves=os.environ.get("PIO_ROLLOUT_WAVES", "1,25%,100%"),
            bake_s=_env_f("PIO_ROLLOUT_BAKE_S", 10.0),
            poll_s=_env_f("PIO_ROLLOUT_POLL_S", 1.0),
            burn_threshold=_env_f("PIO_SLO_BURN_THRESHOLD", 14.4),
            reload_timeout_s=_env_f("PIO_ROLLOUT_RELOAD_TIMEOUT_S", 300.0),
            state_path=os.environ.get("PIO_ROLLOUT_STATE") or None,
        )
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)
        return cfg


class RolloutController:
    """Drive one candidate generation across the fleet in gated waves.

    Clock / sleep / HTTP opener / aggregator are injectable so the test
    matrix stages degraded canaries and preempted controllers with zero
    wall sleeps and real servers."""

    def __init__(self, instances: Sequence[str],
                 config: Optional[RolloutConfig] = None, *,
                 aggregator: Optional[FleetAggregator] = None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 opener: Callable = urlopen,
                 registry=None):
        self.instances = [u.rstrip("/") for u in instances if u.strip()]
        if not self.instances:
            raise ValueError("rollout needs at least one instance URL")
        self.config = config or RolloutConfig.from_env()
        # Remember ownership: a self-built aggregator's scrape pool is
        # released at _finish; an injected one belongs to the caller.
        self._owns_aggregator = aggregator is None
        self.aggregator = aggregator or FleetAggregator(self.instances)
        self._clock = clock
        self._sleep = sleep
        self._opener = opener
        self.state_path = rollout_state_path(self.config.state_path)
        reg = registry or get_registry()
        self._waves_total = reg.counter(
            "pio_rollout_waves_total",
            "Rollout waves completed by outcome (ok/halted).", ("result",))
        self._rollouts_total = reg.counter(
            "pio_rollout_total",
            "Coordinated rollouts by outcome "
            "(promoted/rolled_back/failed).", ("result",))
        self._wave_gauge = reg.gauge(
            "pio_rollout_wave",
            "Wave index the active rollout is promoting (-1 when idle).")

    # -- state journal ------------------------------------------------------

    def _save(self, state: Dict[str, Any]) -> None:
        """Write-ahead journal: atomic tmp+replace, flushed before every
        action, so a controller killed between any two HTTP calls can
        reconstruct exactly what it had already done."""
        state["updatedAt"] = _dt.datetime.now(
            _dt.timezone.utc).isoformat(timespec="seconds")
        self.state_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.state_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(state, indent=1))
        tmp.replace(self.state_path)

    def load_state(self) -> Optional[Dict[str, Any]]:
        try:
            return json.loads(self.state_path.read_text())
        except (OSError, ValueError):
            return None

    # -- per-instance HTTP ops ----------------------------------------------

    def _http_json(self, url: str, method: str = "GET",
                   body: Optional[dict] = None,
                   timeout: float = 30.0) -> tuple:
        data = json.dumps(body).encode() if body is not None else \
            (b"" if method == "POST" else None)
        req = Request(url, data=data, method=method,
                      headers={"Content-Type": "application/json"})
        with self._opener(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read() or b"{}")

    def served_instance(self, url: str) -> Optional[str]:
        """The engine instance id ``url`` is serving right now; None when
        unreachable."""
        try:
            _, body = self._http_json(url + "/")
            return body.get("engineInstanceId")
        except Exception:
            return None

    def _promote_instance(self, url: str, target: Optional[str]) -> tuple:
        """(outcome, detail): ``("ok", loaded_id)`` /
        ``("rejected", msg)`` / ``("unreachable", msg)``."""
        from urllib.error import HTTPError

        body = {"engineInstanceId": target} if target else None
        try:
            _, out = self._http_json(url + "/reload", "POST", body=body,
                                     timeout=self.config.reload_timeout_s)
            return "ok", out.get("engineInstanceId")
        except HTTPError as e:
            payload = e.read()
            try:
                msg = json.loads(payload).get("message", "")
            except Exception:
                msg = payload.decode(errors="replace")[:200]
            if e.code == 409:
                return "rejected", msg[:200]
            return "unreachable", f"HTTP {e.code}: {msg[:200]}"
        except Exception as e:
            return "unreachable", f"{type(e).__name__}: {e}"[:200]

    def _rollback_instance(self, url: str) -> tuple:
        from urllib.error import HTTPError

        try:
            self._http_json(url + "/admin/rollback", "POST",
                            timeout=self.config.reload_timeout_s)
            return "ok", None
        except HTTPError as e:
            return ("no_previous" if e.code == 409
                    else "error"), f"HTTP {e.code}"
        except Exception as e:
            return "unreachable", f"{type(e).__name__}: {e}"[:200]

    # -- the fleet gate -----------------------------------------------------

    def fleet_tripped(self) -> tuple:
        """(tripped?, reason) from ONE fleet-merged scrape: any non-stale
        instance SLO-degraded or fast-burning, or the merged quality
        gate demanding rollback.  A stale (dead) instance never trips
        the gate — it is reported, not treated as burn."""
        try:
            doc = self.aggregator.scrape()
        except Exception as e:
            logger.warning("fleet gate scrape failed: %s", e)
            return False, None
        thr = self.config.burn_threshold
        for row in doc.get("instances", []):
            if row.get("stale"):
                continue
            slo = row.get("slo") or {}
            fast = (slo.get("burn") or {}).get("fast") or {}
            burn = max(float(fast.get("availability", 0.0)),
                       float(fast.get("latency", 0.0)))
            if slo.get("degraded") or burn >= thr:
                return True, (f"slo burn on {row.get('instance')}: "
                              f"degraded={bool(slo.get('degraded'))} "
                              f"fast={burn:g}")
        gate = ((doc.get("merged") or {}).get("quality")
                or {}).get("gate") or {}
        if gate.get("rollback"):
            return True, (f"fleet quality gate: "
                          f"{gate.get('reasons') or 'rollback'}")
        return False, None

    def _bake(self, state: Dict[str, Any]) -> tuple:
        """Watch the fleet gate for the wave's bake window."""
        deadline = self._clock() + self.config.bake_s
        while True:
            tripped, reason = self.fleet_tripped()
            if tripped:
                return True, reason
            if self._clock() >= deadline:
                return False, None
            self._sleep(min(self.config.poll_s,
                            max(deadline - self._clock(), 0.01)))

    # -- drive --------------------------------------------------------------

    def run(self, instance_id: Optional[str] = None) -> Dict[str, Any]:
        """One coordinated rollout of ``instance_id`` (None = each
        server's latest COMPLETED; the first successful promotion pins
        the target for the rest of the fleet).  Returns the final state
        document (also journaled)."""
        wave_counts = parse_waves(self.config.waves, len(self.instances))
        state: Dict[str, Any] = {
            "rolloutId": uuid.uuid4().hex[:12],
            "status": "in_progress",
            "target": instance_id,
            "instances": list(self.instances),
            "waveCounts": wave_counts,
            "wave": 0,
            "promoted": [],
            "skipped": {},
            "rolledBack": [],
            "unwindFailures": {},
            "haltReason": None,
            "startedAt": _dt.datetime.now(
                _dt.timezone.utc).isoformat(timespec="seconds"),
        }
        # Pre-promotion fleet snapshot: what /admin/rollback should
        # restore — recorded so `pio status --fleet` (and the operator)
        # can verify the unwind actually landed.
        state["preRollout"] = {u: self.served_instance(u)
                               for u in self.instances}
        self._save(state)
        publish_event("rollout.start", rolloutId=state["rolloutId"],
                      target=instance_id, instances=len(self.instances))
        return self._execute(state)

    def resume(self, unwind: bool = False) -> Dict[str, Any]:
        """Continue (or unwind) a journaled in-progress rollout after the
        controller was preempted.  Re-verifies which instances ACTUALLY
        serve the target before trusting the journal — a /reload whose
        reply was lost still counts as promoted."""
        state = self.load_state()
        if state is None:
            raise RuntimeError(f"no rollout state at {self.state_path}")
        if state.get("status") not in ("in_progress", "rolling_back"):
            return state  # already terminal
        state["instances"] = [u for u in state.get("instances", [])
                              ] or list(self.instances)
        target = state.get("target")
        if target:
            promoted = set(state.get("promoted", []))
            for url in state["instances"]:
                served = self.served_instance(url)
                if served == target:
                    promoted.add(url)
                elif url in promoted and served is not None:
                    # journal said promoted but the server serves
                    # something else (it rolled itself back, or the
                    # reload never landed) — trust the server
                    promoted.discard(url)
            state["promoted"] = [u for u in state["instances"]
                                 if u in promoted]
        if unwind or state.get("status") == "rolling_back":
            state["haltReason"] = state.get("haltReason") or \
                "operator unwind"
            return self._unwind(state)
        return self._execute(state)

    def _execute(self, state: Dict[str, Any]) -> Dict[str, Any]:
        wave_counts = state["waveCounts"]
        for wave_idx in range(int(state.get("wave", 0)), len(wave_counts)):
            state["wave"] = wave_idx
            self._wave_gauge.set(wave_idx)
            self._save(state)
            target_count = wave_counts[wave_idx]
            for url in state["instances"]:
                if len(state["promoted"]) >= target_count:
                    break
                if url in state["promoted"] or url in state["skipped"]:
                    continue
                outcome, detail = self._promote_instance(
                    url, state.get("target"))
                if outcome == "ok":
                    if state.get("target") is None and detail:
                        # first success pins the fleet-wide target: every
                        # later /reload names THIS instance id, so a
                        # newer COMPLETED train cannot split the wave
                        state["target"] = detail
                    elif detail and state.get("target") \
                            and detail != state["target"]:
                        logger.warning(
                            "rollout: %s loaded %s, not the wave target "
                            "%s", url, detail, state["target"])
                    state["promoted"].append(url)
                    publish_event("rollout.promoted", instance=url,
                                  wave=wave_idx, target=state["target"])
                else:
                    # skip-and-report — a rejecting or dead instance
                    # must never wedge the wave
                    state["skipped"][url] = f"{outcome}: {detail}"
                    publish_event("rollout.skipped", instance=url,
                                  wave=wave_idx, outcome=outcome)
                    logger.warning("rollout: skipping %s (%s: %s)",
                                   url, outcome, detail)
                self._save(state)
            if not state["promoted"]:
                state["status"] = "failed"
                state["haltReason"] = ("no instance accepted the "
                                       "candidate")
                self._finish(state)
                return state
            tripped, reason = self._bake(state)
            if tripped:
                self._waves_total.inc(result="halted")
                state["haltReason"] = reason
                logger.warning("rollout halted at wave %d: %s",
                               wave_idx, reason)
                publish_event("rollout.halted", wave=wave_idx,
                              reason=str(reason)[:200])
                return self._unwind(state)
            self._waves_total.inc(result="ok")
        state["status"] = "promoted"
        self._finish(state)
        return state

    def _unwind(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Roll back EVERY promoted instance (newest first), journaling
        each step; failures are recorded and skipped, never fatal."""
        state["status"] = "rolling_back"
        self._save(state)
        for url in list(reversed(state.get("promoted", []))):
            if url in state.get("rolledBack", []):
                continue
            outcome, detail = self._rollback_instance(url)
            if outcome == "ok":
                state.setdefault("rolledBack", []).append(url)
                publish_event("rollout.rolled_back", instance=url)
            else:
                state.setdefault("unwindFailures", {})[url] = \
                    f"{outcome}: {detail}"
                logger.error("rollout unwind: %s failed on %s (%s)",
                             outcome, url, detail)
            self._save(state)
        state["postRollback"] = {u: self.served_instance(u)
                                 for u in state.get("instances", [])}
        state["status"] = "rolled_back"
        self._finish(state)
        return state

    def _finish(self, state: Dict[str, Any]) -> None:
        self._wave_gauge.set(-1)
        if self._owns_aggregator:
            try:
                self.aggregator.close()
            except Exception:
                pass
        self._rollouts_total.inc(result=state["status"])
        state["finishedAt"] = _dt.datetime.now(
            _dt.timezone.utc).isoformat(timespec="seconds")
        self._save(state)
        publish_event("rollout.finished", rolloutId=state.get("rolloutId"),
                      status=state["status"],
                      promoted=len(state.get("promoted", [])),
                      haltReason=(str(state.get("haltReason"))[:200]
                                  if state.get("haltReason") else None))


class FleetPromoter:
    """The refresh daemon's promoter interface over a wave rollout.

    ``pio train --follow --promote-url URL1,URL2,...`` constructs one of
    these instead of a single-instance ``HttpPromoter``: each refresh
    cycle's new generation rolls across the fleet in gated waves, and
    the daemon's canary verdict is the rollout's outcome (the bake IS
    the canary — there is no second watch window)."""

    def __init__(self, instances: Sequence[str],
                 config: Optional[RolloutConfig] = None, *,
                 opener: Callable = urlopen,
                 controller_factory: Optional[Callable] = None):
        self.instances = [u.rstrip("/") for u in instances if u.strip()]
        self.config = config or RolloutConfig.from_env()
        self._opener = opener
        self._factory = controller_factory or (
            lambda: RolloutController(self.instances, self.config,
                                      opener=self._opener))
        # Non-zero so RefreshDaemon._promote asks for the canary verdict.
        self.canary_window_s = max(self.config.bake_s, 0.001)
        self._last: Optional[Dict[str, Any]] = None

    def promote(self, instance_id: str) -> Dict[str, Any]:
        from predictionio_tpu_torch.refresh.daemon import PromotionRejected

        self._last = self._factory().run(instance_id)
        if self._last.get("status") == "failed":
            raise PromotionRejected(
                f"fleet rollout failed: {self._last.get('haltReason')} "
                f"(skipped: {self._last.get('skipped')})")
        return {"engineInstanceId": self._last.get("target"),
                "rollout": self._last.get("rolloutId")}

    def canary_watch(self) -> str:
        if self._last is not None \
                and self._last.get("status") == "promoted":
            return "promoted"
        return "rolled_back"

    def served_watermark(self):
        """The OLDEST served data watermark across reachable instances —
        the conservative anchor for the staleness gauge: freshness the
        whole fleet serves, not just the luckiest replica."""
        import datetime as dt

        oldest = None
        for url in self.instances:
            try:
                req = Request(url + "/", method="GET")
                with self._opener(req, timeout=10) as resp:
                    body = json.loads(resp.read() or b"{}")
            except Exception:
                continue
            raw = body.get("dataWatermark")
            if not raw:
                continue
            wm = dt.datetime.fromisoformat(raw)
            if oldest is None or wm < oldest:
                oldest = wm
        return oldest
