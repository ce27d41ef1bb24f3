"""The fleet serving plane: coordinated generation rollout.

Port of ``predictionio_tpu/fleet``.  One controller promotes a new
generation across N replicas in waves (1 → 25% → 100%, configurable),
gates every wave on the fleet-merged SLO burn AND the merged
``/quality.json`` verdict, and — when a wave degrades — halts and rolls
back EVERY already-promoted instance through ``/admin/rollback``, so a
bad generation can never stay half-promoted across a load-balanced
fleet.

Multi-instance promotion goes through :class:`~predictionio_tpu_torch.
fleet.rollout.RolloutController`: a loop POSTing ``/reload`` over an
instance list anywhere outside this package has no wave gate, no
journaled state to resume from, and no whole-fleet unwind.

Entry points: ``pio rollout`` (one coordinated rollout, resumable), and
the refresh daemon — ``pio train --follow`` with a comma-separated
``--promote-url`` list promotes every cycle through a
:class:`~predictionio_tpu_torch.fleet.rollout.FleetPromoter` instead of
a single-instance ``HttpPromoter``.
"""

from predictionio_tpu_torch.fleet.rollout import (  # noqa: F401
    FleetPromoter,
    RolloutConfig,
    RolloutController,
    parse_waves,
    rollout_state_path,
)

__all__ = [
    "RolloutController",
    "RolloutConfig",
    "FleetPromoter",
    "parse_waves",
    "rollout_state_path",
]
