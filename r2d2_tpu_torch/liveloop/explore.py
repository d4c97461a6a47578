"""EpsilonAssigner: per-session exploration over live traffic (port of
r2d2_tpu/liveloop/explore.py; the same epsilon per session from the same
seed).

Ape-X gives its actors a ladder of epsilons (ops/epsilon.py). Serving has
no fixed fleet of actors, so the ladder maps onto sessions: at a session's
first sight a seeded coin decides whether it explores at all
(`liveloop_explore_fraction`), and an exploring session draws a uniform
rung of `epsilon_ladder(liveloop_eps_rungs, base_eps, eps_alpha)`. The
epsilon sticks for the session's life, rides every captured transition
(the off-policy audit) and shows in stats(); the other sessions are served
greedy.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.ops.epsilon import epsilon_ladder


class EpsilonAssigner:
    def __init__(self, cfg: R2D2Config, seed: int = 0):
        self.fraction = float(cfg.liveloop_explore_fraction)
        self.ladder = np.asarray(
            epsilon_ladder(cfg.liveloop_eps_rungs, cfg.base_eps, cfg.eps_alpha),
            np.float32,
        )
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._eps: Dict[str, float] = {}
        self._rung_counts = np.zeros(len(self.ladder), np.int64)
        self.greedy_sessions = 0

    def epsilon_for(self, session_id: str) -> float:
        """Sticky per-session epsilon; first sight draws the assignment."""
        with self._lock:
            eps = self._eps.get(session_id)
            if eps is None:
                if self._rng.random() < self.fraction:
                    rung = int(self._rng.integers(len(self.ladder)))
                    eps = float(self.ladder[rung])
                    self._rung_counts[rung] += 1
                else:
                    eps = 0.0
                    self.greedy_sessions += 1
                self._eps[session_id] = eps
            return eps

    def epsilon_of(self, session_id: str):
        """The assignment if one exists (no draw) — for stats/audit."""
        with self._lock:
            return self._eps.get(session_id)

    def forget(self, session_id: str) -> None:
        """Session disconnected; a returning id draws a fresh assignment."""
        with self._lock:
            self._eps.pop(session_id, None)

    def stats(self) -> dict:
        with self._lock:
            explorers = int(self._rung_counts.sum())
            assigned = explorers + self.greedy_sessions
            return {
                "eps_sessions_assigned": assigned,
                "eps_sessions_exploring": explorers,
                "eps_sessions_greedy": self.greedy_sessions,
                "eps_ladder": [float(e) for e in self.ladder],
                "eps_rung_counts": [int(c) for c in self._rung_counts],
                "eps_mean_assigned": (
                    float(np.mean(list(self._eps.values()))) if self._eps else 0.0
                ),
            }
