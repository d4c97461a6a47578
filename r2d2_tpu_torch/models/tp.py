"""The shard-local network of tensor parallelism (port of the JAX package's
``R2D2Network.from_config(cfg, manual_tp=tp)``: models/r2d2.py RowDense,
models/lstm.py's gate seam, models/encoders.py's column-parallel Dense_0).

One batch shard's tp group holds, on each member's device, that member's
contiguous slice of every leaf the sharding table splits
(parallel/sharding_map.py): the column slices of the latent Dense_0, of the
LSTM's wi / wh / b (4H/tp gate columns) and of the dueling hiddens, and the
row slices of the head outs. Everything else (the convolutions, the deeper
latent layers, the out biases, the LRU) is replicated and computed once on
the shard's home device. The seams, in the module math:

- Dense_0: each member computes its latent columns on its device; the
  columns are concatenated on the home device (JAX's all-gather after the
  relu);
- LSTM: the members' wi / wh / b slices are concatenated into the whole
  (D, 4H), (H, 4H) and (4H,) once per unroll, and the unroll runs the
  hand-written kernels on them (the JAX package all-gathers each step's
  gate pre-activations inside its scan instead, which the fused kernels
  cannot host); autograd hands each member the gradient of its own
  columns. Each gate column is the same product as in the split form;
  only the order of the float sums differs;
- heads: each member's hidden columns feed its rows of the out; the
  partial products are summed over the group (learner.tree_sum, JAX's
  psum) and the replicated bias is added once after the sum.

In one process the collectives are concatenation and tree_sum over
tensors moved between the members' devices (no copy where they repeat).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

_LATENT = "enc.tail.dense.0"
_CORE = ("core.wi", "core.wh", "core.b")


class TPView:
    """A network seen through one tp group: `devices` the members' devices
    (member 0's is the network's), `split` the parameters the table splits
    with the dim each splits (sharding_map.tp_split_leaves). With
    `trainable` each member's slices are leaves of their own that collect
    the member's gradient (``grads``). Call it as the network:
    ``view(*unroll_args)``."""

    def __init__(self, net, devices: Sequence[torch.device], split: Dict[str, int],
                 trainable: bool):
        self.net = net
        self.devices = list(devices)
        self.split = split
        self.home = next(net.parameters()).device
        tp = len(self.devices)
        params = dict(net.named_parameters())
        self.pieces: Dict[str, List[torch.Tensor]] = {}
        for key, dim in split.items():
            whole = params[key].detach()
            n = whole.shape[dim] // tp
            pieces = []
            for t, dev in enumerate(self.devices):
                piece = whole.narrow(dim, t * n, n).to(dev)
                pieces.append(piece.requires_grad_() if trainable else piece)
            self.pieces[key] = pieces

    def __call__(self, *args):
        return self.net.unroll(*args, view=self)

    def _gather(self, key: str) -> torch.Tensor:
        """The members' slices of `key` concatenated on the home device."""
        return torch.cat([p.to(self.home) for p in self.pieces[key]], dim=self.split[key])

    # ------------------------------------------------------------ the seams

    def latent(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder with a column-parallel Dense_0: (N, *obs) in [0, 1]
        -> (N, latent)."""
        enc = self.net.enc
        tail = enc.tail
        dtype = tail.dtype
        f = enc.features(x).to(dtype)
        if _LATENT + ".weight" not in self.split:
            return tail(f)
        cols = []
        for w, b, dev in zip(self.pieces[_LATENT + ".weight"], self.pieces[_LATENT + ".bias"],
                             self.devices):
            y = F.linear(f.to(dev), w.to(dtype)) + b.to(dtype)
            cols.append(F.relu(y).to(self.home))
        out = torch.cat(cols, dim=-1)
        for layer in tail.dense[1:]:
            out = F.relu(F.linear(out, layer.weight.to(dtype)) + layer.bias.to(dtype))
        return out

    def core_params(self):
        """The LSTM's (wi, wh, b), gathered from the members' gate columns."""
        return tuple(self._gather(k) for k in _CORE)

    def _head(self, h: torch.Tensor, hidden: str, out: str) -> torch.Tensor:
        from r2d2_tpu_torch.learner import tree_sum

        parts = []
        for wh, bh, wo, dev in zip(self.pieces[hidden + ".weight"], self.pieces[hidden + ".bias"],
                                   self.pieces[out + ".weight"], self.devices):
            a = F.relu(F.linear(h.to(dev), wh, bh))
            parts.append(F.linear(a, wo).to(self.home))
        return tree_sum(parts) + getattr(self.net, out).bias

    def heads(self, h: torch.Tensor):
        """(advantages, value) of float32 head inputs: column-parallel
        hiddens, row-parallel outs, one sum over the group, the bias once."""
        return (self._head(h, "adv_hidden", "adv_out"),
                self._head(h, "val_hidden", "val_out"))

    # ------------------------------------------------------------ gradients

    def grad(self, key: str) -> Optional[torch.Tensor]:
        """The whole gradient of split parameter `key`: the members'
        gradients of their own slices, concatenated on the home device."""
        pieces = self.pieces[key]
        if all(p.grad is None for p in pieces):
            return None
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).to(self.home)
                          for p in pieces], dim=self.split[key])
