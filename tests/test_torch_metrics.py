"""The port's MetricsLogger (r2d2_tpu_torch/utils/metrics.py), as
tests/test_metrics.py holds the JAX package's: numpy and torch values land
as valid jsonl (scalars as numbers, small arrays as lists, big ones as a
summary), and close() is idempotent."""

from __future__ import annotations

import json

import numpy as np
import torch

from r2d2_tpu_torch.utils.metrics import MetricsLogger, _json_default

torch.set_num_threads(1)


def test_log_numpy_and_torch_values(tmp_path):
    path = tmp_path / "m.jsonl"
    m = MetricsLogger(str(path), stdout_interval=1e9)
    m.log(
        {
            "np_scalar": np.float32(1.5),
            "np_int": np.int64(7),
            "np_arr": np.arange(3),
            "np_big": np.zeros((64, 64)),
            "torch_scalar": torch.tensor(2.5),
            "torch_int": torch.tensor(4, dtype=torch.int32),
            "torch_arr": torch.arange(4),
            "torch_bf16": torch.tensor([1.0, 0.5], dtype=torch.bfloat16),
            "torch_big": torch.zeros(64, 64),
            "weird": object(),
            "plain": 3,
        }
    )
    m.close()
    rec = json.loads(path.read_text().strip())
    assert rec["np_scalar"] == 1.5
    assert rec["np_int"] == 7
    assert rec["np_arr"] == [0, 1, 2]
    # big arrays and tensors are summarized, never serialized element-wise
    assert "shape=(64, 64)" in rec["np_big"]
    assert rec["torch_scalar"] == 2.5
    assert rec["torch_int"] == 4
    assert rec["torch_arr"] == [0, 1, 2, 3]
    assert rec["torch_bf16"] == [1.0, 0.5]
    assert "shape=(64, 64)" in rec["torch_big"] and "float32" in rec["torch_big"]
    assert isinstance(rec["weird"], str)
    assert rec["plain"] == 3
    assert "ts" in rec


def test_close_idempotent(tmp_path):
    m = MetricsLogger(str(tmp_path / "m.jsonl"))
    m.log({"a": 1})
    m.close()
    m.close()  # a second close is a no-op, not ValueError
    m2 = MetricsLogger(None)
    m2.log({"a": 1})  # no file: stderr only, still fine
    m2.close()
    m2.close()


def test_json_default_zero_dim_values():
    assert _json_default(np.asarray(3.0)) == 3.0
    assert _json_default(torch.tensor(3)) == 3
    assert _json_default(torch.tensor(3.0, requires_grad=True) * 1) == 3.0
