"""Always-on matching service: coalescing front-end + query planner.

* :mod:`repro_torch.service.queue`   — async request queue; waiting requests
  coalesce into one (Q, T) engine dispatch; admission control sheds
  with a reason, never silently.
* :mod:`repro_torch.service.planner` — telemetry-driven tier router
  (index / linear / approx) with deadline downgrade to the anytime
  tier and its error-bar certificate.
* :mod:`repro_torch.service.session` — the servable façade wiring store +
  index + sharded device verify + obs tracing together.
* :mod:`repro_torch.service.world`   — the session over a
  ``torch.distributed`` world: rank 0 serves through engine fronts, the
  other ranks replay its engine calls in order.
"""

from repro_torch.service.planner import TIERS, PlanDecision, QueryPlanner
from repro_torch.service.queue import (SHED_BAD_QUERY, SHED_DEADLINE,
                                 SHED_ENGINE_ERROR, SHED_QUEUE_FULL,
                                 SHED_SHUTDOWN, CoalescingQueue,
                                 MatchRequest)
from repro_torch.service.session import MatchSession
from repro_torch.service.world import EngineFront, WorldChannel

__all__ = [
    "TIERS", "PlanDecision", "QueryPlanner", "CoalescingQueue",
    "MatchRequest", "MatchSession", "SHED_QUEUE_FULL", "SHED_DEADLINE",
    "SHED_BAD_QUERY", "SHED_SHUTDOWN", "SHED_ENGINE_ERROR",
    "EngineFront", "WorldChannel",
]
