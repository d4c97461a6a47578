"""Array-backed sum tree with stratified sampling and IS weights (port of
r2d2_tpu/replay/sum_tree.py).

Priorities are td^alpha; sampling draws one uniform per equal stratum,
`(arange(n) + U[0,1)) * total / n`, from an explicit numpy Generator;
descent is vectorized layer by layer; IS weights are (p / min_p)^-beta.
With a `native` core (``r2d2_tpu_torch._native``) the update, the descent
and the IS weights run in C++; the strata are drawn here either way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class SumTree:
    def __init__(self, capacity: int, prio_exponent: float = 0.9, is_exponent: float = 0.6,
                 native: Optional[object] = None):
        self.capacity = capacity
        self.num_layers = 1
        while capacity > 2 ** (self.num_layers - 1):
            self.num_layers += 1
        self.leaf_offset = 2 ** (self.num_layers - 1) - 1
        self.tree = np.zeros(2**self.num_layers - 1, dtype=np.float64)
        self.prio_exponent = prio_exponent
        self.is_exponent = is_exponent
        self._native = native

    @property
    def total(self) -> float:
        """The priority mass of every leaf (the root)."""
        return float(self.tree[0])

    def update(self, idxes: np.ndarray, td_errors: np.ndarray) -> None:
        """Set leaf priorities to td^alpha and resum ancestors bottom-up."""
        if len(idxes) == 0:
            return
        if self._native is not None:
            self._native.tree_update(self.tree, self.num_layers, idxes, td_errors,
                                     self.prio_exponent)
            return
        priorities = np.asarray(td_errors, dtype=np.float64) ** self.prio_exponent
        nodes = np.asarray(idxes, dtype=np.int64) + self.leaf_offset
        self.tree[nodes] = priorities
        for _ in range(self.num_layers - 1):
            nodes = np.unique((nodes - 1) // 2)
            self.tree[nodes] = self.tree[2 * nodes + 1] + self.tree[2 * nodes + 2]

    def sample(self, num_samples: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """Stratified sample: (leaf indices, IS weights). Requires total > 0."""
        p_sum = self.tree[0]
        if p_sum <= 0:
            raise ValueError("cannot sample from an empty sum tree")
        interval = p_sum / num_samples
        prefixsums = (
            np.arange(num_samples, dtype=np.float64) + rng.uniform(0.0, 1.0, num_samples)
        ) * interval
        np.clip(prefixsums, 0.0, np.nextafter(p_sum, 0.0), out=prefixsums)

        if self._native is not None:
            nodes = self._native.tree_sample(self.tree, self.num_layers, prefixsums)
            is_weights = self._native.is_weights(self.tree, self.num_layers, nodes,
                                                 self.is_exponent)
            return (nodes - self.leaf_offset).astype(np.int64), is_weights

        nodes = np.zeros(num_samples, dtype=np.int64)
        for _ in range(self.num_layers - 1):
            left = self.tree[nodes * 2 + 1]
            go_left = prefixsums < left
            nodes = np.where(go_left, nodes * 2 + 1, nodes * 2 + 2)
            prefixsums = np.where(go_left, prefixsums, prefixsums - left)

        priorities = self.tree[nodes]
        # a stratum landing on a zero-priority leaf (roundoff) gets the
        # minimum priority, i.e. weight 1.0, instead of 0/0
        positive = priorities[priorities > 0.0]
        min_p = positive.min() if positive.size else 1.0
        is_weights = np.power(np.maximum(priorities, min_p) / min_p, -self.is_exponent)
        return (nodes - self.leaf_offset).astype(np.int64), is_weights.astype(np.float32)

    def priorities_of(self, idxes: np.ndarray) -> np.ndarray:
        return self.tree[np.asarray(idxes, dtype=np.int64) + self.leaf_offset]

    def set_raw(self, idxes: np.ndarray, raw: np.ndarray) -> None:
        """Set leaves to already-exponentiated priorities (as priorities_of
        and leaves read them) and resum their ancestors: the disk tier
        moves leaves between slots with it, where update() would apply
        the exponent again. Writes self.tree in place, which the native
        core shares."""
        idxes = np.asarray(idxes, dtype=np.int64)
        if len(idxes) == 0:
            return
        nodes = idxes + self.leaf_offset
        self.tree[nodes] = np.asarray(raw, dtype=np.float64)
        for _ in range(self.num_layers - 1):
            nodes = np.unique((nodes - 1) // 2)
            self.tree[nodes] = self.tree[2 * nodes + 1] + self.tree[2 * nodes + 2]

    def leaves(self) -> np.ndarray:
        """Raw leaf priorities (already ^alpha), for replay snapshots."""
        return self.tree[self.leaf_offset : self.leaf_offset + self.capacity].copy()

    def load_leaves(self, values: np.ndarray) -> None:
        """Restore raw leaf priorities (as leaves() returns them) and
        rebuild every internal sum bottom-up."""
        if len(values) != self.capacity:
            raise ValueError(f"expected {self.capacity} leaves, got {len(values)}")
        self.tree[:] = 0.0
        self.tree[self.leaf_offset : self.leaf_offset + self.capacity] = values
        for k in range(self.num_layers - 1, 0, -1):
            p = np.arange(2 ** (k - 1) - 1, 2**k - 1)
            self.tree[p] = self.tree[2 * p + 1] + self.tree[2 * p + 2]
