"""Value-function rescaling h and its closed-form inverse (torch and numpy).

    h(x)      = sign(x) * (sqrt(|x| + 1) - 1) + eps * x
    h^{-1}(x) = sign(x) * (((sqrt(1 + 4 eps (|x| + 1 + eps)) - 1) / (2 eps))^2 - 1)

Port of r2d2_tpu/ops/value_rescale.py.
"""

from __future__ import annotations

import numpy as np
import torch


def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def inverse_value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    t = (torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps)) - 1.0) / (2.0 * eps)
    return torch.sign(x) * (torch.square(t) - 1.0)


def value_rescale_np(x: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    return np.sign(x) * (np.sqrt(np.abs(x) + 1.0) - 1.0) + eps * x


def inverse_value_rescale_np(x: np.ndarray, eps: float = 1e-3) -> np.ndarray:
    t = (np.sqrt(1.0 + 4.0 * eps * (np.abs(x) + 1.0 + eps)) - 1.0) / (2.0 * eps)
    return np.sign(x) * (np.square(t) - 1.0)
