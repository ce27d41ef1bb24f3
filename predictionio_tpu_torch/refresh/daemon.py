"""The refresh daemon: ``pio train --follow``.

Port of ``predictionio_tpu/refresh/daemon.py``.  One
:meth:`RefreshDaemon.run_once` is one closed loop iteration:

1. resolve the last COMPLETED generation and its data watermark,
2. load its models and build a :class:`~predictionio_tpu_torch.refresh.
   WarmStartContext` (no watermark / no models → full retrain),
3. ``run_train(warm_from=...)`` — the delta read and the warm-vs-full
   fallback happen inside the workflow,
4. promote the new instance through the serving server's STAGED-RELOAD
   gate (``POST /reload``) — never a direct model write; a
   validation-rejected candidate (409) leaves the old generation
   serving,
5. watch the server's SLO and quality state for the canary window and
   ``POST /admin/rollback`` if either trips,
6. publish freshness: ``pio_refresh_staleness_s`` from the ingest
   high-watermark vs the served generation's data watermark.

A failed cycle (diverged train, unreachable server) records its outcome
and the daemon keeps following — the previous generation keeps serving
throughout, which is the whole point of promoting through the gate.

Clock / sleep / HTTP are injectable so tests drive canary windows and
follow cadences with zero wall sleeps.  The canary window reads the
engine server's ``slo`` in ``/stats.json`` and ``gate.rollback`` in
``/quality.json`` (drift, shadow divergence, recall regression); a
server without them reads "promoted", as the reference's daemon does.
Several
comma-separated promote URLs are fleet mode, whose rollout controller is
not ported: the daemon refuses them rather than promote to one URL.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional
from urllib.error import HTTPError
from urllib.request import Request, urlopen

from predictionio_tpu_torch.controller import (
    Engine,
    EngineVariant,
    RuntimeContext,
)
from predictionio_tpu_torch.obs import publish_event
from predictionio_tpu_torch.obs import trace as obs_trace
from predictionio_tpu_torch.refresh import (
    RefreshConfig,
    RefreshMetrics,
    WarmStartContext,
    data_watermark,
    staleness_s,
)
from predictionio_tpu_torch.resilience.supervision import (
    TrainPreempted,
    preemption_requested,
)
from predictionio_tpu_torch.version import __version__
from predictionio_tpu_torch.workflow.core_workflow import (
    REFRESH_MODE_KEY,
    load_models,
    run_train,
)

logger = logging.getLogger(__name__)

__all__ = ["RefreshDaemon", "HttpPromoter", "PromotionRejected"]


class PromotionRejected(RuntimeError):
    """The staged-reload gate refused the candidate (validation/canary
    failure → HTTP 409).  The previous generation keeps serving."""


def _http_json(url: str, method: str = "GET", timeout: float = 30.0,
               opener: Callable = urlopen) -> tuple:
    req = Request(url, method=method)
    with opener(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read() or b"{}")


class HttpPromoter:
    """Promotes a freshly trained instance through a live engine
    server's staged-reload gate, then watches the SLO burn for the
    canary window.

    The ONLY writes this class performs are ``POST /reload`` and
    ``POST /admin/rollback`` — the refresh loop never touches the model
    store or the server's generation state directly (the reference's
    ``tools/lint_refresh.py`` rules, which the port's tests hold this
    package to).
    """

    def __init__(self, base_url: str, *,
                 canary_window_s: float = 60.0,
                 canary_poll_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 opener: Callable = urlopen):
        self.base_url = base_url.rstrip("/")
        self.canary_window_s = float(canary_window_s)
        self.canary_poll_s = max(float(canary_poll_s), 0.05)
        self._clock = clock
        self._sleep = sleep
        self._opener = opener

    def promote(self, instance_id: str) -> Dict[str, Any]:
        """``POST /reload``: read → build → validate → canary → swap on
        the server.  Raises :class:`PromotionRejected` on 409 (candidate
        failed validation; last-good keeps serving)."""
        try:
            status, body = _http_json(self.base_url + "/reload", "POST",
                                      opener=self._opener)
        except HTTPError as e:
            payload = e.read()
            try:
                msg = json.loads(payload).get("message", "")
            except Exception:
                msg = payload.decode(errors="replace")[:200]
            if e.code == 409:
                raise PromotionRejected(
                    f"staged reload rejected the candidate: {msg}") from e
            raise
        loaded = body.get("engineInstanceId")
        if loaded != instance_id:
            # Another train raced us to COMPLETED; the server loaded the
            # newest one — louder than silent, but not an error: the
            # serving model is still fresher than before.
            logger.warning("promotion loaded instance %s, not the refresh's "
                           "%s (a newer COMPLETED run won the race)",
                           loaded, instance_id)
        return body

    def slo_state(self) -> Dict[str, Any]:
        _, body = _http_json(self.base_url + "/stats.json",
                             opener=self._opener)
        return body.get("slo") or {}

    def quality_state(self) -> Dict[str, Any]:
        """The server's ``/quality.json`` gate document.  Empty on any
        failure — an old server without the endpoint, or a
        poll blip, must never trip a rollback."""
        try:
            _, body = _http_json(self.base_url + "/quality.json",
                                 opener=self._opener)
        except Exception:
            return {}
        return body if isinstance(body, dict) else {}

    def served_watermark(self):
        """The data watermark of the generation the server is ACTUALLY
        serving right now — the authoritative anchor for the staleness
        gauge (a rejected or rolled-back promotion leaves the old
        watermark in place, and the gauge must say so)."""
        _, body = _http_json(self.base_url + "/", opener=self._opener)
        raw = body.get("dataWatermark")
        return _dt.datetime.fromisoformat(raw) if raw else None

    def _burn_tripped(self, slo: Dict[str, Any]) -> bool:
        if slo.get("degraded"):
            return True
        thr = float(slo.get("threshold") or 14.4)
        fast = slo.get("burn", {}).get("fast", {})
        return max(float(fast.get("availability", 0.0)),
                   float(fast.get("latency", 0.0))) >= thr

    @staticmethod
    def _quality_tripped(quality: Dict[str, Any]) -> bool:
        """The server-side quality gate verdict: drift, shadow-canary
        divergence or recall regression, already combined by the server
        (``gate.rollback``), so the daemon reads ONE bit."""
        gate = quality.get("gate") or {}
        return bool(gate.get("rollback"))

    def rollback(self) -> None:
        _http_json(self.base_url + "/admin/rollback", "POST",
                   opener=self._opener)

    def canary_watch(self) -> str:
        """Poll the server's SLO *and* quality state for the canary
        window; roll back when either trips — a promotion that burns
        prediction quality rolls back exactly as one that burns the
        latency SLO.  Returns ``"promoted"`` or ``"rolled_back"``."""
        deadline = self._clock() + self.canary_window_s
        while self._clock() < deadline:
            try:
                slo = self.slo_state()
            except Exception:
                logger.warning("canary SLO poll failed; continuing watch",
                               exc_info=True)
                slo = {}
            if self._burn_tripped(slo):
                logger.warning("SLO burn tripped inside the canary window "
                               "(%s) — rolling the promotion back",
                               slo.get("tripReasons") or "degraded")
                self.rollback()
                return "rolled_back"
            quality = self.quality_state()
            if self._quality_tripped(quality):
                logger.warning(
                    "quality gate tripped inside the canary window (%s) — "
                    "rolling the promotion back",
                    (quality.get("gate") or {}).get("reasons")
                    or "degraded")
                self.rollback()
                return "rolled_back"
            self._sleep(self.canary_poll_s)
        return "promoted"


class RefreshDaemon:
    """Follow-mode retraining on a cadence (``pio train --follow``)."""

    def __init__(self, engine: Engine, variant: EngineVariant,
                 ctx: Optional[RuntimeContext] = None, *,
                 config: Optional[RefreshConfig] = None,
                 promoter: Optional[HttpPromoter] = None,
                 engine_id: Optional[str] = None,
                 engine_version: str = __version__,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        self.engine = engine
        self.variant = variant
        self.ctx = ctx or RuntimeContext.create()
        self.config = config or RefreshConfig.from_env()
        self.engine_id = engine_id or variant.engine_factory
        self.engine_version = engine_version
        self._clock = clock
        self.metrics = RefreshMetrics(registry)
        self.stop_event = threading.Event()
        if promoter is None and self.config.promote_url:
            urls = [u.strip() for u in self.config.promote_url.split(",")
                    if u.strip()]
            if len(urls) > 1:
                # Fleet mode promotes through the wave-based rollout
                # controller (gated waves, whole-fleet rollback), never a
                # bare promote of the first URL; the port has no
                # FleetPromoter yet.
                raise ValueError(
                    f"promote_url names {len(urls)} servers: fleet "
                    "promotion goes through FleetPromoter (the rollout "
                    "controller, ROADMAP Queue 1 item 11), which "
                    "predictionio_tpu_torch does not port yet; give one "
                    "engine-server URL")
            promoter = HttpPromoter(
                urls[0],
                canary_window_s=self.config.canary_window_s,
                canary_poll_s=self.config.canary_poll_s)
        self.promoter = promoter
        # appName out of the variant: the staleness gauge compares the
        # app's ingest high-watermark against the served window.
        ds = (variant.raw.get("datasource") or {}).get("params") or {}
        self.app_name = ds.get("appName")
        # The served generation's watermark, refreshed every cycle (and
        # every trigger poll): the anchor both the staleness gauge and
        # the trigger thresholds measure against.
        self._served_wm = None

    # -- one cycle ----------------------------------------------------------

    def _warm_context(self) -> Optional[WarmStartContext]:
        instances = self.ctx.storage.get_engine_instances()
        prev = instances.get_latest_completed(
            self.engine_id, self.engine_version, self.variant.variant_id)
        if prev is None:
            return None
        wm = data_watermark(prev)
        if wm is None:
            logger.info("previous instance %s has no data watermark "
                        "(pre-refresh generation) — full retrain", prev.id)
            return None
        try:
            models = load_models(self.engine, prev, self.ctx)
        except Exception:
            logger.warning("could not load previous generation %s for "
                           "warm start — full retrain", prev.id,
                           exc_info=True)
            return None
        return WarmStartContext(
            instance=prev, models=models, start_time=wm,
            max_delta_fraction=self.config.max_delta_fraction,
            eval_tolerance=self.config.eval_tolerance)

    def run_once(self) -> Dict[str, Any]:
        """One refresh cycle; returns a summary dict (also published to
        the trace ring as ``refresh.cycle``)."""
        out: Dict[str, Any] = {"promotion": "skipped"}
        t0 = self._clock()
        with obs_trace("refresh.cycle", engine=self.engine_id):
            warm = self._warm_context()
            try:
                instance_id = run_train(
                    self.engine, self.variant, self.ctx,
                    engine_id=self.engine_id,
                    engine_version=self.engine_version,
                    warm_from=warm)
            except TrainPreempted:
                # SIGTERM mid-train: the CLI owns the exit code — not a
                # failed cycle.
                raise
            except Exception as e:
                # A failed train (TrainDiverged, a storage error, no
                # events): the cycle records it and the PREVIOUS
                # generation keeps serving — nothing was promoted.
                self.metrics.runs.inc(result="failed")
                logger.error("refresh train failed: %s", e)
                out.update(result="failed", error=str(e)[:200])
                publish_event("refresh.cycle", **out)
                return out
            finally:
                # The parent generation's models are done with: let their
                # memory go before the promotion loads the new one.
                warm = None
            train_s = self._clock() - t0
            inst = self.ctx.storage.get_engine_instances().get(instance_id)
            mode = (inst.env or {}).get(REFRESH_MODE_KEY, "full") \
                if inst else "full"
            self.metrics.runs.inc(result=mode)
            self.metrics.train_s.set(train_s, mode=mode)
            out.update(result=mode, instance=instance_id,
                       trainS=round(train_s, 3))
            if self.promoter is not None:
                out["promotion"] = self._promote(instance_id)
            self._publish_staleness(inst)
        publish_event("refresh.cycle", **out)
        return out

    def _promote(self, instance_id: str) -> str:
        try:
            self.promoter.promote(instance_id)
        except PromotionRejected as e:
            # The canary gate did its job: candidate rejected, previous
            # generation untouched and still serving.
            self.metrics.promotions.inc(result="rejected")
            logger.warning("promotion rejected: %s", e)
            return "rejected"
        except Exception as e:
            self.metrics.promotions.inc(result="error")
            logger.error("promotion failed: %s", e)
            return "error"
        if self.promoter.canary_window_s > 0:
            verdict = self.promoter.canary_watch()
        else:
            verdict = "promoted"
        self.metrics.promotions.inc(result=verdict)
        return verdict

    def _publish_staleness(self, trained_instance) -> None:
        """Event→servable staleness: ingest high-watermark minus the
        SERVED generation's data watermark.

        With a promoter the served watermark is read back from the
        server itself — a rejected/rolled-back promotion leaves the old
        (staler) watermark serving and the gauge must report THAT, not
        the freshness of an instance nobody serves.  Without a promoter
        the just-trained instance is the newest servable generation and
        anchors the gauge."""
        if not self.app_name:
            return
        if self.promoter is not None:
            try:
                wm = self.promoter.served_watermark()
            except Exception:
                logger.debug("served-watermark probe failed", exc_info=True)
                return
        else:
            wm = data_watermark(trained_instance) \
                if trained_instance is not None else None
        self._served_wm = wm
        self._publish_current_staleness()

    def _publish_current_staleness(self):
        """Staleness vs the last-known served watermark; returns the
        reading (None when either side is unknown).  Trigger mode calls
        this every poll, so the gauge tracks at poll cadence instead of
        once per cycle."""
        if not self.app_name:
            return None
        try:
            latest = self.ctx.event_store.latest_event_time(self.app_name)
        except Exception:
            logger.debug("staleness probe failed", exc_info=True)
            return None
        s = staleness_s(latest, self._served_wm)
        if s is not None:
            self.metrics.staleness.set(s)
        return s

    # -- trigger mode -------------------------------------------------------

    def _trigger_mode(self) -> bool:
        return (self.config.trigger_staleness_s is not None
                or self.config.trigger_delta_count is not None)

    def _delta_count(self, cap: int) -> int:
        """Events ingested past the served watermark, counted up to
        ``cap`` (the threshold) — the read never scans further than the
        decision needs."""
        if not self.app_name or self._served_wm is None:
            return 0
        try:
            it = self.ctx.event_store.find(
                self.app_name, start_time=self._served_wm, limit=cap)
            return sum(1 for _ in it)
        except Exception:
            logger.debug("delta-count probe failed", exc_info=True)
            return 0

    def _trigger_ready(self, cycle_started: float):
        """(fire?, reason) — staleness or delta-count threshold crossed,
        or the fixed-cadence backstop elapsed."""
        cfg = self.config
        if self._clock() - cycle_started >= cfg.interval_s:
            return True, "interval"
        if cfg.trigger_staleness_s is not None:
            s = self._publish_current_staleness()
            if s is not None and s >= cfg.trigger_staleness_s:
                return True, "staleness"
        if cfg.trigger_delta_count is not None:
            cap = max(int(cfg.trigger_delta_count), 1)
            if self._delta_count(cap) >= cap:
                return True, "delta_count"
        return False, None

    def _await_trigger(self, sleep: Optional[Callable[[float], None]]
                       ) -> Optional[str]:
        """Poll the trigger conditions until one fires (returns its
        reason) or the daemon is stopped (returns None).  The freshness
        gauges become actuators: a quiet app idles past its cadence-free
        poll loop; a burst of events or a staleness breach fires a cycle
        within one poll tick."""
        started = self._clock()
        poll = max(self.config.trigger_poll_s, 0.01)
        while not self.stop_event.is_set() and not preemption_requested():
            fire, reason = self._trigger_ready(started)
            if fire:
                self.metrics.triggers.inc(reason=reason)
                publish_event("refresh.trigger", reason=reason)
                logger.info("refresh trigger fired: %s", reason)
                return reason
            if sleep is not None:
                sleep(poll)
            elif self.stop_event.wait(poll):
                return None
        return None

    # -- follow mode --------------------------------------------------------

    def follow(self, sleep: Callable[[float], None] = None,
               on_cycle: Optional[Callable[[Dict[str, Any]], None]] = None
               ) -> int:
        """Loop ``run_once`` until :attr:`stop_event` (or a
        SIGTERM-driven preemption request) stops it — on the fixed
        cadence by default, or trigger-driven when a staleness /
        delta-count threshold is configured (the interval then acts as a
        backstop ceiling, never a floor).  ``on_cycle`` receives each
        cycle's summary (``pio train --follow`` prints it).  Returns the
        number of completed cycles."""
        cycles = 0
        while not self.stop_event.is_set() and not preemption_requested():
            started = self._clock()
            out = self.run_once()
            cycles += 1
            if on_cycle is not None:
                on_cycle(out)
            if self.stop_event.is_set() or preemption_requested():
                break
            if self._trigger_mode():
                if self._await_trigger(sleep) is None:
                    break
                continue
            elapsed = self._clock() - started
            wait = max(self.config.interval_s - elapsed, 0.0)
            if sleep is not None:
                sleep(wait)
            else:
                # Interruptible wait: a SIGTERM between cycles stops the
                # daemon within one poll tick, not one interval.
                if self.stop_event.wait(wait):
                    break
        return cycles

    def stop(self) -> None:
        self.stop_event.set()
