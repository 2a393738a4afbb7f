"""Telemetry-driven query planner: route each request to a tier.

The service front-end (``repro_torch.service.session``) serves three tiers
over one engine:

* ``"index"``  — exact top-k through the split-tree candidate source
  (sublinear candidates examined; requires ``store.build_index()``).
* ``"linear"`` — exact top-k through the full lower-bound sweep.
* ``"approx"`` — the anytime tier: bounded-collect indexed matching
  (``TreeCandidates`` approximate mode) whose k-th-best lower bound is
  reported back as a per-query error bar; without an index it falls
  back to representation-top-k verification (no certificate).

A session configured with a ``repro_torch.profile.SelfJoinEngine``
additionally carries the corpus-level ``"selfjoin"`` tier (exact
motif/discord requests over the matrix profile).  It is deliberately
NOT in ``TIERS`` — per-query routing never lands there; only
``kind="motifs"`` / ``"discords"`` requests are forced onto it.

Routing combines two signals:

* a **modeled cost** per tier — candidate-count priors scaled by the
  corpus size, billed through the store's I/O cost model
  (``RawStore.modeled_io_seconds``) plus a per-candidate verification
  rate.  This is what the planner answers with before it has seen any
  traffic.
* a **rolling estimate** learned from observation — the obs registry's
  per-call latency and candidate counts (``observe`` after every
  dispatch, plus ``seed_from_metrics`` to adopt a registry's existing
  ``match.topk_latency_s`` history at startup) folded in as an EWMA.
  After a few dispatches the learned estimate dominates the prior.

Deadline handling: a request whose remaining deadline cannot cover the
chosen exact tier's estimated latency (times a safety factor) is
DOWNGRADED to the approximate tier rather than shed — the anytime
tier's error bar makes the degradation measurable, which is the
contract that lets the service keep its never-silently-drop promise
while staying inside latency budgets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: The routable tiers, in the order the planner prefers them when
#: estimates tie ("index" first: it never examines more than linear).
TIERS = ("index", "linear", "approx")

#: Candidate-count priors as a fraction of the corpus, used until real
#: observations replace them.  Linear's prior reflects the paper's
#: pruned-scan behaviour (a few percent of rows examined); the index
#: prior is an order of magnitude tighter; approx is O(k).
_CAND_FRACTION = {"index": 0.005, "linear": 0.05}

#: Per-candidate verification cost prior (seconds/row) and fixed
#: per-dispatch overhead prior — replaced by EWMAs as traffic arrives.
_VERIFY_S_PER_ROW = 2e-6
_DISPATCH_OVERHEAD_S = 2e-3


@dataclass
class PlanDecision:
    """One routing decision, attached to the request as ``req.plan``."""

    tier: str      # one of TIERS
    reason: str    # "cost" | "deadline" | "forced" | "only_tier"
    est_s: float   # planner's latency estimate for this dispatch

    @property
    def downgraded(self) -> bool:
        return self.reason == "deadline"


class _TierEstimate:
    """EWMA of observed per-dispatch wall time and per-query candidate
    count for one tier, seeded from the modeled prior."""

    __slots__ = ("wall_s", "cands", "n_obs")

    def __init__(self, wall_s: float, cands: float):
        self.wall_s = float(wall_s)
        self.cands = float(cands)
        self.n_obs = 0

    def observe(self, wall_s: float, cands: float, alpha: float) -> None:
        if self.n_obs == 0:          # first observation replaces the prior
            self.wall_s = float(wall_s)
            self.cands = float(cands)
        else:
            self.wall_s += alpha * (float(wall_s) - self.wall_s)
            self.cands += alpha * (float(cands) - self.cands)
        self.n_obs += 1


class QueryPlanner:
    """Cost-model + rolling-estimate router (see module docstring).

    Parameters
    ----------
    total:       corpus size (rows / windows) for the modeled priors.
    has_index:   whether the exact "index" tier is servable.
    has_approx:  whether the "approx" tier is servable (the subsequence
                 engine's anytime tier needs the window index).
    store:       optional ``RawStore``-protocol object; its
                 ``modeled_io_seconds`` prices the candidate priors.
    safety:      deadline downgrade margin: an exact tier is considered
                 deadline-threatened when ``est * safety`` exceeds the
                 remaining budget.
    alpha:       EWMA smoothing factor for observations.
    """

    def __init__(self, *, total: int = 0, has_index: bool = False,
                 has_approx: bool = True, has_selfjoin: bool = False,
                 store=None, safety: float = 2.0,
                 alpha: float = 0.3, approx_collect: int = 32):
        self.total = int(total)
        self.has_index = bool(has_index)
        self.has_approx = bool(has_approx)
        self.has_selfjoin = bool(has_selfjoin)
        self.safety = float(safety)
        self.alpha = float(alpha)
        self._store = store
        self._est = {
            "index": _TierEstimate(*self._prior("index", approx_collect)),
            "linear": _TierEstimate(*self._prior("linear", approx_collect)),
            "approx": _TierEstimate(*self._prior("approx", approx_collect)),
        }
        if self.has_selfjoin:
            # the self-join tier answers corpus-level requests (motifs /
            # discords): its prior is a full-corpus candidate sweep, and
            # the session's profile cache makes repeat requests all but
            # free — the EWMA learns that after the first dispatch.  It
            # is NOT in TIERS: per-query requests never route to it.
            self._est["selfjoin"] = _TierEstimate(
                self.modeled_cost(float(self.total)), float(self.total))
        # per-replica dispatch-wall EWMAs (replicated sessions): the
        # placement signal behind ``place`` — learned, not configured
        self._replica_wall: dict = {}

    # -- modeled cost ------------------------------------------------------
    def _prior(self, tier: str, approx_collect: int):
        if tier == "approx":
            cands = float(approx_collect)
        else:
            cands = max(32.0, _CAND_FRACTION[tier] * self.total)
        return self.modeled_cost(cands), cands

    def modeled_cost(self, cands: float) -> float:
        """Seconds to verify ``cands`` candidates under the store's I/O
        model plus the verification-rate and dispatch-overhead priors."""
        io_s = 0.0
        if self._store is not None and hasattr(self._store,
                                               "modeled_io_seconds"):
            io_s = float(self._store.modeled_io_seconds(int(cands), 1))
        return _DISPATCH_OVERHEAD_S + cands * _VERIFY_S_PER_ROW + io_s

    # -- telemetry in ------------------------------------------------------
    def estimate(self, tier: str) -> float:
        """Current per-dispatch latency estimate for ``tier``."""
        return self._est[tier].wall_s

    def observe(self, tier: str, q_n: int, wall_s: float, res) -> None:
        """Fold one dispatch into the tier's rolling estimate.  ``res``
        is the engine result (its ``raw_accesses`` are the observed
        candidate counts the cost model learns from)."""
        cands = float(res.raw_accesses.mean()) if q_n else 0.0
        self._est[tier].observe(wall_s, cands, self.alpha)

    def observe_replica(self, replica: int, wall_s: float) -> None:
        """Fold one dispatch's wall time into the replica's EWMA (the
        placement signal for replicated sessions)."""
        rid = int(replica)
        prev = self._replica_wall.get(rid)
        if prev is None:
            self._replica_wall[rid] = float(wall_s)
        else:
            self._replica_wall[rid] = \
                prev + self.alpha * (float(wall_s) - prev)

    def place(self, live, depths) -> int:
        """Pick a replica for one batch: minimize (queued batches + 1)
        × the replica's EWMA dispatch wall — i.e. expected time until
        the batch would finish there.  Replicas never observed use the
        mean of the observed EWMAs (or the exact-tier estimate when
        none exist), so a fresh replica is neither shunned nor
        blindly preferred.  Ties break on the lowest replica id —
        deterministic placement under equal load."""
        if not live:
            raise ValueError("place() needs at least one live replica")
        known = [w for r, w in self._replica_wall.items() if r in live]
        default = (sum(known) / len(known)) if known else max(
            self.estimate("index") if self.has_index else 0.0,
            self.estimate("linear"))
        return min(live, key=lambda r: (
            (depths.get(r, 0) + 1)
            * self._replica_wall.get(r, default), r))

    def seed_from_metrics(self, metrics) -> None:
        """Adopt an obs registry's existing latency history as the
        exact-tier prior (``match.topk_latency_s`` / the subsequence
        twin) — the service then starts from observed reality instead
        of the modeled prior when the registry has seen traffic."""
        if metrics is None:
            return
        for name in ("match.topk_latency_s", "subseq.topk_latency_s"):
            snap = metrics.snapshot().get("histograms", {}).get(name)
            if not snap or not snap.get("count"):
                continue
            from repro_torch.obs.metrics import Histogram
            p50 = Histogram.from_dict(snap).quantile(0.5)
            if p50 == p50 and p50 != float("inf"):     # not NaN/inf
                for tier in ("index", "linear"):
                    if self._est[tier].n_obs == 0:
                        self._est[tier].wall_s = float(p50)
            return

    # -- routing -----------------------------------------------------------
    def servable(self, tier: str) -> bool:
        if tier == "index":
            return self.has_index
        if tier == "approx":
            return self.has_approx
        if tier == "selfjoin":
            return self.has_selfjoin
        return tier == "linear"

    def route(self, *, k: int = 1,
              deadline_left: Optional[float] = None,
              tier: Optional[str] = None) -> PlanDecision:
        """Pick the tier for one request.

        ``tier``: explicit caller override (validated upstream by the
        session's admission check).  ``deadline_left``: remaining
        latency budget in seconds; when the cheapest exact tier cannot
        meet it (with the safety margin), the request is downgraded to
        the approximate tier with ``reason="deadline"``.
        """
        if tier is not None:
            return PlanDecision(tier, "forced", self.estimate(tier))
        if self.has_index and \
                self.estimate("index") <= self.estimate("linear"):
            exact = "index"
        else:
            exact = "linear"
        est = self.estimate(exact)
        if deadline_left is not None and self.has_approx \
                and est * self.safety > deadline_left:
            return PlanDecision("approx", "deadline",
                                self.estimate("approx"))
        reason = "cost" if self.has_index else "only_tier"
        return PlanDecision(exact, reason, est)

    # -- reporting / persistence -------------------------------------------
    def snapshot(self) -> dict:
        """Plain-JSON view of the rolling tier estimates (launcher /
        bench reporting, and the persisted half of the planner state —
        see ``seed_from_snapshot``)."""
        return {tier: {"wall_s": e.wall_s, "cands": e.cands,
                       "n_obs": e.n_obs}
                for tier, e in self._est.items()}

    def replicas_snapshot(self) -> dict:
        """Plain-JSON view of the per-replica EWMAs (persisted next to
        ``snapshot()`` by the session's save path)."""
        return {str(r): float(w) for r, w in self._replica_wall.items()}

    def seed_from_snapshot(self, snap: dict,
                           replicas: Optional[dict] = None) -> None:
        """Adopt a persisted ``snapshot()`` as this planner's starting
        estimates — a restarted service plans from the traffic the
        previous process observed instead of the modeled priors.  Only
        tiers this planner has NOT yet observed are seeded (live
        observations always beat history); unknown tiers in the
        snapshot are ignored.  ``replicas`` seeds the per-replica
        placement EWMAs the same way."""
        for tier, e in (snap or {}).items():
            est = self._est.get(tier)
            if est is None or est.n_obs:
                continue
            try:
                est.wall_s = float(e["wall_s"])
                est.cands = float(e["cands"])
                est.n_obs = int(e.get("n_obs", 0))
            except (KeyError, TypeError, ValueError):
                continue
        for r, w in (replicas or {}).items():
            try:
                rid = int(r)
            except (TypeError, ValueError):
                continue
            if rid not in self._replica_wall:
                self._replica_wall[rid] = float(w)
