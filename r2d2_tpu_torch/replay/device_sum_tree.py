"""Device-resident sum tree: stratified sampling and priority write-back on
the card (port of r2d2_tpu/replay/device_sum_tree.py).

The float32 tensor twin of replay/sum_tree.SumTree: the same layout (one
flat tensor, leaf_offset = 2**(num_layers-1) - 1), the same stratum
arithmetic ((arange(n) + U[0,1)) * p_sum / n, the right edge clipped to
nextafter(p_sum, 0)), the same layer-by-layer descent, the same
(max(p, min_p)/min_p)^-beta IS weights with the zero-leaf fallback, and the
same pointer-window staleness verdict. Every function is a pure function of
tensors on any device that reads nothing back to the host, so the learner's
superstep (megastep.make_priority_superstep) samples, trains and writes
priorities back with no host in between.

Two differences from the host tree, as in the JAX package:

- float32 storage; every internal node is recomputed from its children on
  each update (full-layer strided sums), never accumulated, so the error
  does not grow with the number of updates;
- duplicate leaves in one update resolve to the LAST valid occurrence,
  decided by an O(M^2) last-occurrence argmax, so the scatter writes one
  value per leaf (an ``index_put_`` with repeated indices and different
  values is nondeterministic on CUDA).

The uniforms of a draw come from an explicit ``torch.Generator``
(``tree_sample``), or are handed in (``tree_descend``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def tree_layers(capacity: int) -> int:
    """Minimal num_layers with capacity <= 2**(num_layers-1), as
    SumTree.__init__ computes it."""
    num_layers = 1
    while capacity > 2 ** (num_layers - 1):
        num_layers += 1
    return num_layers


def leaf_offset(num_layers: int) -> int:
    return 2 ** (num_layers - 1) - 1


def tree_size(num_layers: int) -> int:
    return 2 ** num_layers - 1


def tree_init(capacity: int, device="cpu") -> torch.Tensor:
    return torch.zeros(tree_size(tree_layers(capacity)), dtype=torch.float32, device=device)


def _resum(tree: torch.Tensor, num_layers: int) -> torch.Tensor:
    """Rebuild every internal node from its children, bottom-up, in place:
    full-layer strided slices, so each parent is an exact child sum."""
    for k in range(num_layers - 1, 0, -1):
        p0, p1 = 2 ** (k - 1) - 1, 2 ** k - 1
        tree[p0:p1] = tree[2 * p0 + 1 : 2 * p1 : 2] + tree[2 * p0 + 2 : 2 * p1 + 1 : 2]
    return tree


def tree_update(
    tree: torch.Tensor,
    num_layers: int,
    idxes: torch.Tensor,
    td_errors: torch.Tensor,
    prio_exponent: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """A new tree with the leaves at `idxes` set to td**prio_exponent and
    every internal node resummed. Rows where `mask` is False are dropped;
    of duplicate indices the LAST valid occurrence wins."""
    dev = tree.device
    off = leaf_offset(num_layers)
    values = torch.pow(td_errors.to(dev, torch.float32), float(prio_exponent))
    idxes = idxes.to(dev, torch.int64)
    m = idxes.shape[0]
    valid = (torch.ones(m, dtype=torch.bool, device=dev) if mask is None
             else mask.to(dev, torch.bool))
    safe = torch.where(valid, idxes, torch.zeros_like(idxes))
    # score[i, j] = j where row j targets row i's leaf and is valid, else
    # -1; the argmax over j is row i's winner
    ar = torch.arange(m, dtype=torch.int64, device=dev)
    same = safe[None, :] == safe[:, None]
    score = torch.where(same & valid[None, :], ar[None, :], torch.full_like(same, -1,
                                                                              dtype=torch.int64))
    best = torch.max(score, dim=1).values
    has = best >= 0
    win = best.clamp(min=0)
    out = tree.clone()
    val = torch.where(has, values[win], tree[off + safe])
    # duplicates all carry their winner's value: the scatter is deterministic
    out[off + safe] = val
    return _resum(out, num_layers)


def tree_descend(tree: torch.Tensor, num_layers: int, u: torch.Tensor) -> torch.Tensor:
    """Leaf indices (int64) of the strata whose uniforms are `u` (n,):
    SumTree.sample's stratum arithmetic and layer descent. The caller
    guarantees total > 0; an empty tree descends to leaf 0."""
    n = u.shape[0]
    p_sum = tree[0]
    interval = p_sum / float(n)
    pref = (torch.arange(n, dtype=torch.float32, device=tree.device)
            + u.to(tree.device, torch.float32)) * interval
    # guard the right edge against float accumulation (as the host tree)
    edge = torch.nextafter(p_sum, torch.zeros_like(p_sum))
    pref = torch.minimum(torch.clamp(pref, min=0.0), edge)
    nodes = torch.zeros(n, dtype=torch.int64, device=tree.device)
    for _ in range(num_layers - 1):
        left = tree[nodes * 2 + 1]
        go_left = pref < left
        nodes = torch.where(go_left, nodes * 2 + 1, nodes * 2 + 2)
        pref = torch.where(go_left, pref, pref - left)
    return nodes - leaf_offset(num_layers)


def tree_sample(tree: torch.Tensor, num_layers: int, num_samples: int,
                generator: torch.Generator) -> torch.Tensor:
    """Stratified sample of `num_samples` leaf indices, the uniforms drawn
    from `generator` (on the tree's device)."""
    u = torch.rand(num_samples, generator=generator, device=tree.device, dtype=torch.float32)
    return tree_descend(tree, num_layers, u)


def is_weights(tree: torch.Tensor, num_layers: int, idxes: torch.Tensor,
               is_exponent: float) -> torch.Tensor:
    """(max(p, min_p) / min_p)^-beta over the batch, min_p the smallest
    positive sampled priority (1.0 when there is none: zero leaves get the
    largest weight instead of NaN, as on the host)."""
    p = tree[idxes.to(tree.device, torch.int64) + leaf_offset(num_layers)]
    pos_min = torch.min(torch.where(p > 0.0, p, torch.full_like(p, float("inf"))))
    min_p = torch.where(torch.isfinite(pos_min), pos_min, torch.ones_like(pos_min))
    return torch.pow(torch.maximum(p, min_p) / min_p, -float(is_exponent))


def priorities_of(tree: torch.Tensor, num_layers: int, idxes: torch.Tensor) -> torch.Tensor:
    return tree[idxes.to(tree.device, torch.int64) + leaf_offset(num_layers)]


def stale_mask(idxes: torch.Tensor, old_ptr, ptr, seqs_per_block: int, old_advances,
               advances, num_blocks: int) -> torch.Tensor:
    """The pointer-window verdict of ReplayControlPlane.update_priorities
    with no branch on the data: True where the leaf survived the round
    trip. ptr == old_ptr accepts all, unless the advance stamps show a full
    ring lap, which rejects all."""
    S = seqs_per_block
    lo = torch.as_tensor(old_ptr, device=idxes.device).to(idxes.dtype) * S
    hi = torch.as_tensor(ptr, device=idxes.device).to(idxes.dtype) * S
    fwd = (idxes < lo) | (idxes >= hi)
    wrap = (idxes < lo) & (idxes >= hi)
    everything = torch.ones_like(fwd)
    m = torch.where(hi > lo, fwd, torch.where(hi < lo, wrap, everything))
    lap = (torch.as_tensor(advances, device=idxes.device)
           - torch.as_tensor(old_advances, device=idxes.device)) >= num_blocks
    return m & ~lap


def tree_from_leaves(leaves: np.ndarray, capacity: int, device="cpu") -> torch.Tensor:
    """The flat tree from raw leaf priorities (already ^alpha), the internal
    sums computed bottom-up in numpy float32 before one upload (the restore
    half of snapshots). The sums are the same float32 additions _resum
    makes, so a tree restored from its own leaves is the same bits."""
    num_layers = tree_layers(capacity)
    off = leaf_offset(num_layers)
    flat = np.zeros(tree_size(num_layers), np.float32)
    flat[off : off + capacity] = np.asarray(leaves, np.float32)[:capacity]
    for k in range(num_layers - 1, 0, -1):
        p = np.arange(2 ** (k - 1) - 1, 2 ** k - 1)
        flat[p] = flat[2 * p + 1] + flat[2 * p + 2]
    return torch.from_numpy(flat).to(device)


class DeviceSumTree:
    """Host-side handle over the functional core, with the slice of
    SumTree's interface the control plane and snapshots use (update /
    sample / priorities_of / leaves / load_leaves). Ingestion and retirement
    go through update(); the superstep reads `tree` and installs its output
    through swap()."""

    def __init__(self, capacity: int, prio_exponent: float = 0.9, is_exponent: float = 0.6,
                 device="cpu"):
        self.capacity = capacity
        self.device = torch.device(device)
        self.num_layers = tree_layers(capacity)
        self.leaf_offset = leaf_offset(self.num_layers)
        self.prio_exponent = prio_exponent
        self.is_exponent = is_exponent
        self.tree = tree_init(capacity, self.device)

    @property
    def total(self) -> float:
        return float(self.tree[0])

    def update(self, idxes: np.ndarray, td_errors: np.ndarray) -> None:
        if len(idxes) == 0:
            return
        self.tree = tree_update(
            self.tree, self.num_layers,
            torch.from_numpy(np.asarray(idxes, np.int64)).to(self.device),
            torch.from_numpy(np.asarray(td_errors, np.float32)).to(self.device),
            self.prio_exponent,
        )

    def sample(self, num_samples: int, generator: torch.Generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(leaf indices, IS weights) as tensors on the tree's device."""
        idx = tree_sample(self.tree, self.num_layers, num_samples, generator)
        return idx, is_weights(self.tree, self.num_layers, idx, self.is_exponent)

    def priorities_of(self, idxes: np.ndarray) -> np.ndarray:
        idx = torch.from_numpy(np.asarray(idxes, np.int64)).to(self.device)
        return priorities_of(self.tree, self.num_layers, idx).cpu().numpy()

    def swap(self, tree: torch.Tensor) -> None:
        """Install a superstep's output tree as the live state."""
        self.tree = tree

    def leaves(self) -> np.ndarray:
        return self.tree[self.leaf_offset : self.leaf_offset + self.capacity].cpu().numpy()

    def load_leaves(self, values: np.ndarray) -> None:
        if len(values) != self.capacity:
            raise ValueError(f"expected {self.capacity} leaves, got {len(values)}")
        self.tree = tree_from_leaves(values, self.capacity, self.device)
