"""TransitionTap: served traffic captured as replay blocks (port of
r2d2_tpu/liveloop/tap.py; the same blocks, stamps and snapshot arrays).

The serve plane sees what R2D2 replay needs: each request brings (obs_t,
reward_{t-1}, reset_t), the serve step gives (q_t, action_t) and writes the
new carry, and the publish cell stamps (ckpt_step, params_version) on every
answer. The tap records those facts per served batch, off the hot path, and
plays them per session through the actor's own `SequenceAccumulator`
(replay/accumulator.py), so a live block has the stored state, burn-in and
n-step returns of an actor-collected one.

Serving shifts the actor's order by one request: the reward and next obs
of the action chosen at request t arrive with request t+1. The tap holds
one pending tuple (action_t, q_t, hidden_t, eps_t, version_t) per session
and completes it at the next request:

    continuing row t+1:  acc.add(a_t, reward_row, obs_row, q_t, hidden_t);
                         a full block finishes with last_qval = q_{t+1}
    reset row:           the pending transition completes with the row's
                         reward (the previous episode's last, which the
                         client sends on its reset request and the policy
                         ignores), finish(None), and the stream reseeds.

Two approximations, as in the JAX package: the terminal frame never
reaches the server, so the reset row's obs stands in for it (gamma_n = 0
zeroes its bootstrap), and a cache-eviction seam (a fresh admission with
no client reset) ends the block as a terminal, since the carry is lost.

On the serve side the cost is one gather of the batch's new carries
(`gather_carry_rows`: `index_select` and a cast to float32, at dispatch,
on the serving stream; see serve/server.py) and a bounded deque append;
the accumulation runs on the supervised "liveloop-tap" thread. The deque
drops its oldest record under pressure (counted), and a session seen in a
dropped record has its partial block cut cleanly at its next sight: a drop
costs data, never the correctness of what is emitted.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from r2d2_tpu_torch.config import R2D2Config
from r2d2_tpu_torch.replay.accumulator import SequenceAccumulator


def gather_carry_rows(h_store, c_store, slots):
    """The batch rows' carries out of the session stores, cast to float32
    (the cache may hold bf16; the accumulator takes (2, H) float32): two new
    tensors on the stores' device (host arrays are taken as CPU tensors)."""
    h_store, c_store = torch.as_tensor(h_store), torch.as_tensor(c_store)
    slots = torch.as_tensor(slots, dtype=torch.long, device=h_store.device)
    return (torch.index_select(h_store, 0, slots).to(torch.float32),
            torch.index_select(c_store, 0, slots).to(torch.float32))


def _host(x) -> np.ndarray:
    """A host array of a tensor (copied off the device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class BatchRecord:
    """One served batch's tap-relevant facts, already on host."""

    sids: List[str]
    obs: np.ndarray        # (n, *obs_shape)
    actions: np.ndarray    # (n,) int
    qvals: np.ndarray      # (n, A) f32
    rewards: np.ndarray    # (n,) f32 — reward_{t-1}, rides request t
    resets: np.ndarray     # (n,) bool — effective (client reset | fresh)
    eps: np.ndarray        # (n,) f32 — per-row exploration epsilon
    h_rows: np.ndarray     # (n, H) f32 post-step carry
    c_rows: np.ndarray     # (n, H) f32
    ckpt_step: int
    version: int


class _SessionStream:
    """Per-session accumulator + the one-step pending tuple + audit stamps
    (one (epsilon, params_version) per added transition)."""

    __slots__ = ("acc", "pending", "eps_stamps", "ver_stamps")

    def __init__(self, cfg: R2D2Config):
        self.acc = SequenceAccumulator(cfg)
        self.pending = None  # (action, q, hidden(2,H), eps, version)
        self.eps_stamps: List[float] = []
        self.ver_stamps: List[int] = []


class TransitionTap:
    """Bounded batch-record queue + per-session stream state.

    `observe_batch` is the only method the serve loop calls; everything
    else runs on the liveloop-tap thread (or synchronously in tests via
    `process_pending`). Counters and the record queue share one lock;
    per-session streams are touched only by the processing side, so the
    serve loop is never blocked on accumulation.
    """

    def __init__(self, cfg: R2D2Config, depth: Optional[int] = None,
                 emit: Optional[Callable] = None):
        self.cfg = cfg
        self.depth = int(depth if depth is not None else cfg.liveloop_tap_depth)
        # r2d2: ephemeral(process-local plumbing: the owner rewires the callback via set_emit on every (re)construction, it is never part of replayed state)
        self._emit = emit  # (block, priorities, episode_reward) -> None
        self._lock = threading.Lock()
        self._q: deque = deque()
        self._wake = threading.Event()
        self._sessions: Dict[str, _SessionStream] = {}
        # r2d2: ephemeral(only guards seam accounting for batches still queued in _q; the tap thread drains _q before any snapshot cut, so it is empty whenever carry_state runs)
        self._broken: set = set()  # sids whose continuity a drop severed
        # r2d2: ephemeral(pending disconnects are applied by the same process_pending cycle that would precede a snapshot cut; a resumed run re-evicts via live disconnects)
        self._evictions: List[str] = []  # disconnects queued for the tap thread
        # counters (all guarded by _lock) — monitoring only: stats() feeds
        # the metrics stream, never replay or the resume fingerprint, so a
        # resumed process restarts them from zero by design
        # r2d2: ephemeral(monitoring counter; stats-only, restarts at 0 on resume)
        self.captured_steps = 0
        # r2d2: ephemeral(monitoring counter; stats-only, restarts at 0 on resume)
        self.emitted_blocks = 0
        # r2d2: ephemeral(monitoring counter; stats-only, restarts at 0 on resume)
        self.dropped_batches = 0
        # r2d2: ephemeral(monitoring counter; stats-only, restarts at 0 on resume)
        self.seam_breaks = 0
        # bounded off-policy audit trail: per emitted block, the aligned
        # (epsilon, params_version) stamps of its transitions
        self.audit_tail: deque = deque(maxlen=64)

    def set_emit(self, emit: Callable) -> None:
        self._emit = emit

    # ------------------------------------------------------------ serve side

    def gather_rows(self, h_store, c_store, slots):
        """The batch's carry gather, launched on the caller's thread (the
        serve thread, at dispatch) so the stream orders it after the step's
        in-place write and before the next batch's; -> the (h, c) float32
        pair for a later `observe_batch(rows=...)`, read on the completion
        side."""
        return gather_carry_rows(h_store, c_store, slots)

    def observe_batch(
        self,
        sids: Sequence[str],
        obs: np.ndarray,
        actions: np.ndarray,
        qvals: np.ndarray,
        rewards: np.ndarray,
        resets: np.ndarray,
        eps: np.ndarray,
        ckpt_step: int,
        version: int,
        h_store,
        c_store,
        slots: np.ndarray,
        rows=None,
    ) -> None:
        """Record one served batch (first n = len(sids) rows of each array
        are real; pads were already sliced off by the caller or are sliced
        here). `rows` (an (h_rows, c_rows) pair, gathered by the server at
        dispatch) skips the carry gather, and h_store/c_store may then be
        None; without it the rows are gathered from the stores here. One
        bounded append either way."""
        n = len(sids)
        if rows is not None:
            h_rows, c_rows = rows
        else:
            h_rows, c_rows = gather_carry_rows(h_store, c_store, slots[:n])
        rec = BatchRecord(
            sids=list(sids),
            obs=np.asarray(obs[:n]),
            actions=np.asarray(actions[:n]),
            qvals=np.asarray(qvals[:n], np.float32),
            rewards=np.asarray(rewards[:n], np.float32),
            resets=np.asarray(resets[:n], bool),
            eps=np.asarray(eps[:n], np.float32),
            h_rows=_host(h_rows),
            c_rows=_host(c_rows),
            ckpt_step=int(ckpt_step),
            version=int(version),
        )
        with self._lock:
            if len(self._q) >= self.depth:
                dropped = self._q.popleft()
                self.dropped_batches += 1
                self._broken.update(dropped.sids)
            self._q.append(rec)
        self._wake.set()

    def observe_evict(self, sid: str) -> None:
        """Session disconnected (client thread): queue the eviction so the
        tap thread — the only writer of per-session streams — applies it.
        The session's partial block is cut (pending-Q bootstrap) and its
        stream dropped at the next drain."""
        with self._lock:
            self._evictions.append(sid)
        self._wake.set()

    # -------------------------------------------------------- processing side

    def process_pending(self, timeout: float = 0.0) -> int:
        """Drain and accumulate every queued record; returns records
        processed. The liveloop-tap thread body calls this with a small
        timeout; tests call it with timeout=0 for synchronous drains."""
        if timeout > 0.0 and not self._wake.wait(timeout):
            return 0
        with self._lock:
            records = list(self._q)
            self._q.clear()
            self._wake.clear()
            broken, self._broken = self._broken, set()
            evictions, self._evictions = self._evictions, []
        for rec in records:
            self._apply(rec, broken)
        for sid in evictions:
            # single-writer contract: _sessions is only ever mutated by
            # the processing side — the liveloop-tap worker while it runs,
            # or the owning thread (tests, stop(), snapshot) strictly
            # before/after the worker's lifetime. Cross-thread inputs all
            # arrive through the lock-guarded record/eviction queues.
            # r2d2: disable=cross-thread-unguarded-write  (the contract above)
            st = self._sessions.pop(sid, None)
            if st is not None and st.acc.size > 0:
                last_q = st.pending[1] if st.pending is not None else None
                self._finish(sid, st, last_qval=last_q)
        return len(records)

    def _apply(self, rec: BatchRecord, broken=None) -> None:
        broken = set() if broken is None else broken
        for i, sid in enumerate(rec.sids):
            st = self._sessions.get(sid)
            severed = sid in broken
            if severed:
                broken.discard(sid)
            if st is not None and severed:
                # continuity severed by a dropped record: cut the partial
                # block cleanly (pending.q is Q of the obs after the last
                # added transition — the correct cut bootstrap), reseed
                if st.acc.size > 0:
                    last_q = st.pending[1] if st.pending is not None else None
                    self._finish(sid, st, last_qval=last_q)
                with self._lock:
                    self.seam_breaks += 1
                st = None
            row_obs = rec.obs[i]
            hidden = np.stack([rec.h_rows[i], rec.c_rows[i]])
            if st is None:
                st = _SessionStream(self.cfg)
                st.acc.reset(row_obs)
                self._sessions[sid] = st  # r2d2: disable=cross-thread-unguarded-write  (single-writer contract in process_pending)
            elif rec.resets[i]:
                if st.pending is not None:
                    # reset-row reward = previous episode's terminal reward;
                    # row_obs stands in for the unseen terminal frame
                    self._add(st, float(rec.rewards[i]), row_obs)
                    self._finish(sid, st, last_qval=None)
                st.acc.reset(row_obs)
            else:
                if st.pending is None:
                    # tap attached mid-session (or state lost): reseed
                    with self._lock:
                        self.seam_breaks += 1
                    st.acc.reset(row_obs)
                else:
                    self._add(st, float(rec.rewards[i]), row_obs)
                    if st.acc.size == self.cfg.block_length:
                        self._finish(sid, st, last_qval=rec.qvals[i])
            st.pending = (
                int(rec.actions[i]), rec.qvals[i], hidden,
                float(rec.eps[i]), rec.version,
            )

    def _add(self, st: _SessionStream, reward: float, next_obs: np.ndarray) -> None:
        action, q, hidden, eps, version = st.pending
        st.acc.add(action, reward, next_obs, q, hidden)
        st.eps_stamps.append(eps)
        st.ver_stamps.append(version)
        with self._lock:
            self.captured_steps += 1

    def _finish(self, sid: str, st: _SessionStream, last_qval) -> None:
        block, priorities, episode_reward = st.acc.finish(last_qval=last_qval)
        audit = {
            "session": sid,
            "epsilon": np.asarray(st.eps_stamps, np.float32),
            "params_version": np.asarray(st.ver_stamps, np.int64),
        }
        st.eps_stamps = []
        st.ver_stamps = []
        with self._lock:
            self.emitted_blocks += 1
            self.audit_tail.append(audit)
        st.pending = None
        if self._emit is not None:
            self._emit(block, priorities, episode_reward)

    def flush(self) -> int:
        """Cut every in-flight partial block (stop/drain time). Pending
        transitions cannot complete (their reward never arrived) so each
        partial is bootstrapped from its pending Q like a block cut."""
        cut = 0
        for sid, st in list(self._sessions.items()):
            if st.acc.size > 0:
                last_q = st.pending[1] if st.pending is not None else None
                self._finish(sid, st, last_qval=last_q)
                cut += 1
            del self._sessions[sid]  # r2d2: disable=cross-thread-unguarded-write  (single-writer contract in process_pending)
        return cut

    # --------------------------------------------------------- snapshot/stats

    def carry_state(self) -> dict:
        """Per-session mutable state as npz-safe arrays (mirrors
        SequenceAccumulator.carry_state) for mid-loop snapshot/resume."""
        out = {}
        for sid, st in self._sessions.items():
            d = st.acc.carry_state()
            d["eps_stamps"] = np.asarray(st.eps_stamps, np.float64)
            d["ver_stamps"] = np.asarray(st.ver_stamps, np.int64)
            d["has_pending"] = np.asarray(int(st.pending is not None), np.int64)
            if st.pending is not None:
                action, q, hidden, eps, version = st.pending
                d["pending_action"] = np.asarray(action, np.int64)
                d["pending_q"] = np.asarray(q, np.float32)
                d["pending_hidden"] = np.asarray(hidden, np.float32)
                d["pending_eps"] = np.asarray(eps, np.float64)
                d["pending_version"] = np.asarray(version, np.int64)
            out[sid] = d
        return out

    def restore_carry(self, state: dict) -> None:
        self._sessions.clear()  # r2d2: disable=cross-thread-unguarded-write  (single-writer contract in process_pending)
        for sid, d in state.items():
            st = _SessionStream(self.cfg)
            st.acc.restore_carry(d)
            st.eps_stamps = [float(e) for e in d["eps_stamps"]]
            st.ver_stamps = [int(v) for v in d["ver_stamps"]]
            if int(np.asarray(d["has_pending"])[()]):
                st.pending = (
                    int(np.asarray(d["pending_action"])[()]),
                    np.asarray(d["pending_q"], np.float32),
                    np.asarray(d["pending_hidden"], np.float32),
                    float(np.asarray(d["pending_eps"])[()]),
                    int(np.asarray(d["pending_version"])[()]),
                )
            self._sessions[sid] = st  # r2d2: disable=cross-thread-unguarded-write  (single-writer contract in process_pending)

    def stats(self) -> dict:
        with self._lock:
            return {
                "tap_captured_steps": self.captured_steps,
                "tap_emitted_blocks": self.emitted_blocks,
                "tap_dropped_batches": self.dropped_batches,
                "tap_seam_breaks": self.seam_breaks,
                "tap_queue_depth": len(self._q),
                "tap_open_sessions": len(self._sessions),
            }
