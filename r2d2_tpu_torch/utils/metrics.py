"""Structured metrics (port of r2d2_tpu/utils/metrics.py).

Every record is a structured dict written as one jsonl line (a
machine-readable learning curve) and mirrored to stderr at a throttled
cadence.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

# arrays up to this many values are written out; larger ones as a summary
_MAX_LISTED = 32


def _json_default(v: Any) -> Any:
    """Serializer fallback for non-JSON values in metric records: numpy and
    torch scalars -> Python numbers, small arrays and tensors -> lists, big
    ones -> a shape/dtype summary (a learning-curve line must never carry a
    multi-megabyte tensor), anything else -> float, or str."""
    if isinstance(v, torch.Tensor):
        if v.ndim == 0:
            return v.item()
        if v.numel() <= _MAX_LISTED:
            return v.tolist()
        return f"<tensor shape={tuple(v.shape)} dtype={v.dtype}>"
    if isinstance(v, np.ndarray):
        if v.ndim == 0:
            return v.item()
        if v.size <= _MAX_LISTED:
            return v.tolist()
        return f"<array shape={v.shape} dtype={v.dtype}>"
    if isinstance(v, np.generic):
        return v.item()
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, stdout_interval: float = 10.0):
        self.path = path
        self._fh = open(path, "a", buffering=1) if path else None
        self.stdout_interval = stdout_interval
        self._last_print = 0.0

    def log(self, record: Dict[str, Any], force_print: bool = False) -> None:
        record = {"ts": time.time(), **record}
        if self._fh:
            self._fh.write(json.dumps(record, default=_json_default) + "\n")
        now = time.time()
        if force_print or now - self._last_print >= self.stdout_interval:
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in record.items()
                if k != "ts"
            )
            print(parts, file=sys.stderr)
            self._last_print = now

    def close(self) -> None:
        """Idempotent: more than one teardown path may close the logger."""
        fh, self._fh = self._fh, None
        if fh is not None and not fh.closed:
            fh.close()
