"""The device-resident session-state cache and its host spill slab (port of
r2d2_tpu/serve/state_cache.py).

A served policy is stateful: every session carries an LSTM carry, its last
action and its last reward from one request to the next. They live here,
in fixed-capacity tensors on the serving device, and a request carries only
its session id. The serve step gathers the rows of a batch's sessions,
advances them and writes the new rows back in place (``write``): the
recurrent state never leaves the device between requests.

On the host an LRU map session id -> row (an OrderedDict: a hit moves to the
back, an eviction pops the front). The tensors hold one more row at index
``capacity``: a bucket's pad rows gather from it and write into it, so a
partly filled batch needs no masking in the step.

With ``spill_capacity > 0`` an LRU eviction demotes the victim's (h, c,
last action, last reward) into a preallocated host slab, one CPU tensor per
field in the cache dtype itself (float32, or bfloat16, which torch keeps on
the host as it is: the round trip is bit exact), allocated lazily through
numpy so a slab of millions of sessions costs pages only as it fills. A
returning spilled session is promoted back carry intact. Rows cross
between the tiers in one gather or scatter per batch, never per session.
Only a session the slab never saw, or dropped, starts fresh: zero carry,
action 0, reward 0, the training episode start (models/r2d2.initial_carry).
Without a slab an evicted session that returns is admitted fresh.

Single writer: only the thread driving batches (the serve loop, or the
caller before ``start``) touches the device rows, and ``assign`` runs only
there. The host maps and counters are under a lock, so ``reset``,
``evict`` and ``stats`` may be called from any thread. The depth-2
pipeline keeps this: a batch's ``assign`` (at stage time) and its
``write`` (at dispatch) run back to back on the serve thread, and the next
batch's ``assign`` comes after; the device stream orders batch k's write
before batch k + 1's gather.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np
import torch

from r2d2_tpu_torch.config import resolve_device


def dtype_name(dtype: torch.dtype) -> str:
    """"float32" / "bfloat16", as the JAX package names its dtypes."""
    return str(dtype).replace("torch.", "")


def _host_zeros(shape, dtype: torch.dtype) -> torch.Tensor:
    """A zeroed CPU tensor whose pages are taken as they are written
    (numpy's zeros; a bfloat16 slab as the uint16 bits viewed)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.zeros(shape, np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.zeros(shape, torch.empty((), dtype=dtype).numpy().dtype))


class RecurrentStateCache:
    """Fixed-capacity device store: session id -> (carry, last action, last
    reward), LRU eviction into an optional host spill slab."""

    def __init__(self, capacity: int, hidden_dim: int, dtype: torch.dtype = torch.float32,
                 spill_capacity: int = 0, device="cuda"):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        if spill_capacity < 0:
            raise ValueError("spill_capacity must be >= 0 (0 disables)")
        self.capacity = capacity
        self.hidden_dim = hidden_dim
        # the carry's storage dtype: float32, or bfloat16 under the bf16
        # precision policy (cfg.state_dtype)
        self.dtype = dtype
        self.device = resolve_device(device)
        rows = capacity + 1  # + the scratch row of the pad rows
        self.h = torch.zeros((rows, hidden_dim), dtype=dtype, device=self.device)
        self.c = torch.zeros((rows, hidden_dim), dtype=dtype, device=self.device)
        self.last_action = torch.zeros(rows, dtype=torch.int32, device=self.device)
        self.last_reward = torch.zeros(rows, dtype=torch.float32, device=self.device)
        self._slots: "OrderedDict[str, int]" = OrderedDict()
        self._free: List[int] = list(range(capacity))
        self._lock = threading.Lock()
        self.spill_capacity = spill_capacity
        if spill_capacity > 0:
            self._spill_h = _host_zeros((spill_capacity, hidden_dim), dtype)
            self._spill_c = _host_zeros((spill_capacity, hidden_dim), dtype)
            self._spill_la = _host_zeros((spill_capacity,), torch.int32)
            self._spill_lr = _host_zeros((spill_capacity,), torch.float32)
        self._spill_slots: "OrderedDict[str, int]" = OrderedDict()
        self._spill_free: List[int] = list(range(spill_capacity))
        # counters (under _lock)
        self.evictions = 0        # device rows reclaimed (spilled or dropped)
        self.admissions = 0       # sessions given a device row on a miss
        self.hits = 0
        self.misses = 0
        self.spills = 0           # sessions demoted into the slab
        self.promotes = 0         # sessions promoted back, carry intact
        self.readmits = 0         # misses that found spilled state
        self.spill_evictions = 0  # slab LRU drops (the state is lost)
        self.imports = 0          # sessions migrated in from another cache
        self.spill_sheds = 0      # slab rows dropped by shed_spill

    @property
    def pad_slot(self) -> int:
        """The scratch row the pad rows gather from and write into."""
        return self.capacity

    def __len__(self) -> int:
        with self._lock:
            return len(self._slots)

    def __contains__(self, session_id: str) -> bool:
        with self._lock:
            return session_id in self._slots

    def spilled(self, session_id: str) -> bool:
        with self._lock:
            return session_id in self._spill_slots

    # ------------------------------------------------------------ admission

    def assign(self, session_ids: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Map session ids to rows, admitting unknown sessions (evicting the
        LRU session when full, into the slab when there is one). -> (slots,
        fresh): fresh[i] marks a session that starts from the zero state
        (never seen, or its spilled state dropped); a promoted session is
        not fresh, its carry is back in its row when this returns. Ids must
        be unique within a call (the batcher sends a session at most once a
        batch). Serve thread only: demotion and promotion touch the rows."""
        if len(set(session_ids)) != len(session_ids):
            raise ValueError("duplicate session ids in one batch")
        slots = np.empty(len(session_ids), np.int32)
        fresh = np.zeros(len(session_ids), bool)
        demote: List[Tuple[str, int]] = []   # (sid, device row) victims
        promote: List[Tuple[int, int]] = []  # (device row, slab row)
        with self._lock:
            for i, sid in enumerate(session_ids):
                slot = self._slots.get(sid)
                if slot is None:
                    self.misses += 1
                    self.admissions += 1
                    if self._free:
                        slot = self._free.pop()
                    else:
                        # the LRU front is never this batch's: its members
                        # were just moved to the back
                        victim, slot = self._slots.popitem(last=False)
                        self.evictions += 1
                        if self.spill_capacity > 0:
                            demote.append((victim, slot))
                    row = self._spill_slots.pop(sid, None)
                    if row is not None:
                        self.readmits += 1
                        self.promotes += 1
                        promote.append((slot, row))
                    else:
                        fresh[i] = True
                else:
                    self.hits += 1
                self._slots[sid] = slot
                self._slots.move_to_end(sid)
                slots[i] = slot
        # device IO outside the lock. When a batch both promotes and demotes:
        # 1. lift the promoted rows out of the slab and free them, before a
        #    demotion may reuse a freed slab row;
        # 2. demote: read the victims' device rows into the slab;
        # 3. promote: write the lifted rows into their device rows, after
        #    the demotion read, since a victim's row may be where a promoted
        #    session lands.
        staged = self._stage_promotions(promote) if promote else None
        if promote:
            with self._lock:
                self._spill_free.extend(row for _, row in promote)
        if demote:
            self._demote(demote)
        if staged is not None:
            self._promote(promote, staged)
        return slots, fresh

    # ------------------------------------------------------- tier movement

    def _gather_rows(self, rows: Sequence[int]):
        """The device rows' four fields on the host, in one gather each."""
        idx = torch.tensor(list(rows), dtype=torch.long, device=self.device)
        return tuple(t.index_select(0, idx).cpu()
                     for t in (self.h, self.c, self.last_action, self.last_reward))

    def _demote(self, victims: List[Tuple[str, int]]) -> None:
        """Copy the victims' device rows into the slab: one gather and read
        back for the whole batch's evictions."""
        h_rows, c_rows, la_rows, lr_rows = self._gather_rows([s for _, s in victims])
        with self._lock:
            for j, (sid, _) in enumerate(victims):
                row = self._spill_slots.pop(sid, None)
                if row is None:
                    if self._spill_free:
                        row = self._spill_free.pop()
                    else:
                        # slab full: the LRU spilled session is lost
                        _, row = self._spill_slots.popitem(last=False)
                        self.spill_evictions += 1
                self._spill_h[row] = h_rows[j]
                self._spill_c[row] = c_rows[j]
                self._spill_la[row] = la_rows[j]
                self._spill_lr[row] = lr_rows[j]
                self._spill_slots[sid] = row
                self._spill_slots.move_to_end(sid)
                self.spills += 1

    def _stage_promotions(self, moves: List[Tuple[int, int]]):
        """The promoted sessions' slab rows, copied out before this batch's
        demotions write the slab."""
        rows = torch.tensor([r for _, r in moves], dtype=torch.long)
        return (self._spill_h[rows], self._spill_c[rows], self._spill_la[rows],
                self._spill_lr[rows])

    def _promote(self, moves: List[Tuple[int, int]], staged) -> None:
        """Write the lifted slab rows into their new device rows, in place:
        one copy to the device and one indexed write per field."""
        idx = torch.tensor([s for s, _ in moves], dtype=torch.long, device=self.device)
        for t, rows in zip((self.h, self.c, self.last_action, self.last_reward), staged):
            t.index_copy_(0, idx, rows.to(self.device))

    def export_sessions(self) -> "OrderedDict[str, tuple]":
        """Every tracked session's (h, c, last action, last reward) on the
        host in the cache dtype, LRU-oldest first (spilled ones first, then
        the resident ones in one gather), for migration to another cache.
        Only with this cache's serve loop stopped."""
        with self._lock:
            resident = list(self._slots.items())
            spilled = list(self._spill_slots.items())
        out: "OrderedDict[str, tuple]" = OrderedDict()
        for sid, row in spilled:
            out[sid] = (self._spill_h[row].clone(), self._spill_c[row].clone(),
                        self._spill_la[row].clone(), self._spill_lr[row].clone())
        if resident:
            h_rows, c_rows, la_rows, lr_rows = self._gather_rows([s for _, s in resident])
            for j, (sid, _) in enumerate(resident):
                out[sid] = (h_rows[j], c_rows[j], la_rows[j], lr_rows[j])
        return out

    def import_spilled(self, session_id: str, h, c, last_action, last_reward) -> bool:
        """Admit a migrated session's carry into this cache's slab, bit for
        bit. False when there is no slab, no free slab row (a migrant never
        evicts a session here) or the session is already tracked."""
        with self._lock:
            if self.spill_capacity == 0 or not self._spill_free:
                return False
            if session_id in self._slots or session_id in self._spill_slots:
                return False
            row = self._spill_free.pop()
            self._spill_h[row] = torch.as_tensor(h)
            self._spill_c[row] = torch.as_tensor(c)
            self._spill_la[row] = torch.as_tensor(last_action)
            self._spill_lr[row] = torch.as_tensor(last_reward)
            self._spill_slots[session_id] = row
            self.imports += 1
            return True

    def shed_spill(self, keep_fraction: float) -> int:
        """Drop the LRU spilled sessions until the slab holds at most
        `keep_fraction` of its capacity; -> how many were dropped."""
        target = int(self.spill_capacity * max(min(keep_fraction, 1.0), 0.0))
        dropped = 0
        with self._lock:
            while len(self._spill_slots) > target:
                _, row = self._spill_slots.popitem(last=False)
                self._spill_free.append(row)
                self.spill_evictions += 1
                self.spill_sheds += 1
                dropped += 1
        return dropped

    def reset(self, session_id: str) -> None:
        """Forget a session entirely, its device row and any spilled copy:
        its next request starts fresh (a promoted stale carry would undo the
        reset)."""
        self.evict(session_id)

    def evict(self, session_id: str) -> bool:
        """Free a session's device row and slab row (a client disconnect):
        no demotion, since no later request will promote it. -> whether
        anything was freed."""
        with self._lock:
            slot = self._slots.pop(session_id, None)
            if slot is not None:
                self._free.append(slot)
            row = self._spill_slots.pop(session_id, None)
            if row is not None:
                self._spill_free.append(row)
            return slot is not None or row is not None

    # ------------------------------------------------------------ device IO

    def arrays(self):
        """The device tensors the serve step reads and writes."""
        return self.h, self.c, self.last_action, self.last_reward

    def write(self, slots: torch.Tensor, h, c, last_action, last_reward) -> None:
        """The serve step's new rows into the cache's own tensors, in place
        (h and c cast to the cache dtype). Pad rows all write the scratch
        row; the real rows are unique (one request per session a batch).
        Serve thread only."""
        self.h.index_copy_(0, slots, h.to(self.dtype))
        self.c.index_copy_(0, slots, c.to(self.dtype))
        self.last_action.index_copy_(0, slots, last_action.to(torch.int32))
        self.last_reward.index_copy_(0, slots, last_reward.to(torch.float32))

    @property
    def session_carry_bytes(self) -> int:
        """Device bytes of recurrent state a session holds: its h and c."""
        return 2 * self.hidden_dim * self.h.element_size()

    def device_bytes(self) -> int:
        """Device bytes of the four tensors, the scratch row included."""
        return sum(t.numel() * t.element_size() for t in self.arrays())

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "cache_sessions": len(self._slots),
                "cache_capacity": self.capacity,
                "cache_evictions": self.evictions,
                "cache_admissions": self.admissions,
                "cache_hits": self.hits,
                "cache_misses": self.misses,
                "cache_hit_rate": self.hits / lookups if lookups else 0.0,
                "cache_readmits": self.readmits,
                "cache_spills": self.spills,
                "cache_promotes": self.promotes,
                "cache_spill_evictions": self.spill_evictions,
                "cache_imports": self.imports,
                "cache_spill_sheds": self.spill_sheds,
                "spill_sessions": len(self._spill_slots),
                "spill_capacity": self.spill_capacity,
                "cache_dtype": dtype_name(self.dtype),
                "session_carry_bytes": self.session_carry_bytes,
            }
