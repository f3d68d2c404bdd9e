"""Helpers shared by the entry points."""

from __future__ import annotations

import os

import numpy as np


def ensure_dirs(*names: str) -> None:
    for name in names:
        os.makedirs(name, exist_ok=True)


def temp_grid(min_temp: float, max_temp: float, n: int) -> np.ndarray:
    """``n`` temperatures log-spaced over [min_temp, max_temp]."""
    return np.logspace(np.log10(min_temp), np.log10(max_temp), n)
