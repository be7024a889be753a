"""Real-time client availability simulation (``ClientSimConfig``).

The paper's core claim is that double sampling + weight inheritance keep
the architecture search stable while clients *come and go* — the
defining constraint of mobile federated NAS (Zhu, Zhang & Jin 2020; Xu
et al., DecNAS).  ``ClientSimulator`` turns that into a per-round draw
the engine applies between participant sampling and the strategy:

  * **availability** — each sampled client checks in with probability
    ``availability`` (or its ``availability_trace`` entry, or a
    probability drawn once per client from the compact
    ``availability_dist`` spec — see ``_DIST_STREAM``).  Absent
    clients receive nothing and cost nothing; the round's client groups
    are formed over the available subset only, degrading gracefully all
    the way to empty groups (``core.double_sampling``).
  * **dropout / deadline** — each checked-in client then fails before
    its uploads with probability ``dropout``, and independently misses
    the round when its simulated finish time ``speed × U(0.8, 1.2)``
    exceeds ``round_deadline`` (stragglers carry
    ``straggler_slowdown``× speed, assigned to a fixed
    ``straggler_fraction`` of the population per run).  Both land in
    ``RoundSim.dropped``: downloads already pushed to them are booked on
    the ``CommStats`` wasted ledger, and they contribute to neither
    aggregation nor evaluation.

All draws come from the simulator's own RNG stream (``ClientSimConfig
.seed``), never from the engine's search RNG — so turning the simulation
on cannot shift participant sampling or offspring variation, and the
draw order is fixed on the host, which keeps the survivor sets (and
therefore CommStats) byte-identical across execution backends.  An
inactive config (the default) draws nothing at all.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.engine.types import ClientSimConfig

_EMPTY_IDS = np.empty(0, dtype=np.int64)

# Salt mixed into the simulator's SeedSequence so ClientSimConfig.seed=k
# NEVER yields the same PCG64 stream as the engine's default_rng(k) —
# with the obvious defaults (both seeds 0) the availability draws would
# otherwise replay the search's participant/offspring uniforms verbatim,
# silently correlating who drops with what evolves.
_SIM_STREAM_SALT = 0x5EEDFA11

# Sub-stream tag for the counter-based per-client availability draws
# (``ClientSimConfig.availability_dist``): client ``cid``'s personal
# probability comes from ``default_rng((_SIM_STREAM_SALT, seed,
# _DIST_STREAM, cid))`` — O(1) state for any fleet size, deterministic
# per client no matter which rounds sample it, and disjoint from both
# the search stream and the simulator's own round stream.
_DIST_STREAM = 0xD157


@dataclasses.dataclass(frozen=True)
class RoundSim:
    """One round's availability outcome.

    ``participants`` are the checked-in clients (engine sampling order
    preserved — group sampling permutes them with the *search* RNG, as
    ever).  ``survivors`` is ``None`` when the simulation is inactive
    (the exact legacy path); otherwise the frozenset of client ids that
    complete their uploads.  ``dropped`` lists the participants that
    downloaded but never upload this round."""
    participants: np.ndarray
    survivors: Optional[frozenset]
    dropped: np.ndarray
    n_sampled: int

    @property
    def active(self) -> bool:
        return self.survivors is not None

    @property
    def n_dropped(self) -> int:
        return len(self.dropped)

    @property
    def n_survivors(self) -> int:
        """Surviving participant count (all of them when inactive)."""
        return (len(self.participants) if self.survivors is None
                else len(self.survivors))

    @classmethod
    def inactive(cls, participants: np.ndarray) -> "RoundSim":
        participants = np.asarray(participants)
        return cls(participants, None, _EMPTY_IDS, len(participants))


class ClientSimulator:
    """Per-run simulator state: the sim RNG stream and the fixed
    straggler speed assignment.  Built fresh by every ``FedEngine.run``
    so runs are re-entrant and seed-deterministic."""

    def __init__(self, cfg: ClientSimConfig, num_clients: int):
        self.cfg = cfg
        self.active = cfg.is_active
        self.num_clients = num_clients
        trace = cfg.availability_trace
        if trace is not None and len(trace) != num_clients:
            raise ValueError(
                f"availability_trace has {len(trace)} entries for "
                f"{num_clients} clients")
        self._trace = (np.asarray(trace, dtype=float)
                       if trace is not None else None)
        self.rng = np.random.default_rng((_SIM_STREAM_SALT, cfg.seed))
        # straggler speeds are the only per-client array left, and only
        # when stragglers are actually configured — every other per-client
        # quantity is answered lazily for the sampled ids, so simulator
        # state is O(1) in fleet size on the 10^6-client paths
        self.speed = None
        if self.active and cfg.straggler_fraction > 0.0:
            self.speed = np.ones(num_clients)
            k = int(round(cfg.straggler_fraction * num_clients))
            slow = self.rng.permutation(num_clients)[:k]
            self.speed[slow] = cfg.straggler_slowdown

    def _dist_p(self, cid: int) -> float:
        """Client ``cid``'s fixed check-in probability under
        ``availability_dist``, from its counter-based personal stream."""
        name = self.cfg.availability_dist[0]
        params = self.cfg.availability_dist[1:]
        r = np.random.default_rng(
            (_SIM_STREAM_SALT, self.cfg.seed, _DIST_STREAM, int(cid)))
        if name == "bernoulli":
            return 1.0 if r.random() < params[0] else 0.0
        if name == "uniform":
            lo, hi = params
            return lo + (hi - lo) * r.random()
        return float(r.beta(params[0], params[1]))   # "beta"

    def _avail_p(self, ids: np.ndarray) -> np.ndarray:
        """Per-client P(available) for ``ids`` only — O(len(ids)),
        whatever the fleet size."""
        if self._trace is not None:
            return self._trace[ids]
        if self.cfg.availability_dist is not None:
            return np.asarray([self._dist_p(int(c)) for c in ids])
        return np.full(len(ids), self.cfg.availability)

    def draw_round(self, sampled: np.ndarray) -> RoundSim:
        """Draw this round's availability outcome for the sampled
        participants (order-preserving filter)."""
        sampled = np.asarray(sampled)
        if not self.active:
            return RoundSim.inactive(sampled)
        cfg, rng = self.cfg, self.rng
        avail = sampled[rng.random(len(sampled)) < self._avail_p(sampled)]
        drop = rng.random(len(avail)) < cfg.dropout
        if cfg.round_deadline is not None:
            t = rng.uniform(0.8, 1.2, size=len(avail))
            if self.speed is not None:
                t = self.speed[avail] * t
            drop |= t > cfg.round_deadline
        survivors = frozenset(int(c) for c in avail[~drop])
        return RoundSim(avail, survivors, avail[drop], len(sampled))
