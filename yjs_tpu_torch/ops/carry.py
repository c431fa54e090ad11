"""Carry device state across from the JAX engine, and back out.

This system has no weights: a doc's state crosses between the packages
as wire bytes (its update log, or ``encode_state_as_update``), whose
format both packages share.  What is specific to a device is the three
resident tables, and this module moves those:

- :func:`tables_from_numpy` takes the JAX engine's tables as numpy
  arrays (``np.asarray(eng._right)`` and so on) and returns the port's
  tensors on ``device``;
- :func:`trim_tables` reads an engine's tables back trimmed to each
  doc's live rows and segments — the format the parity tests compare,
  since capacity padding may differ between engines.
"""

from __future__ import annotations

import numpy as np
import torch


def tables_from_numpy(right, deleted, starts, *, device):
    """``(right [B, cap+1] i32, deleted [B, cap+1] bool, starts [B, S+1]
    i32)`` numpy arrays -> the same three tables as torch tensors on
    ``device`` (fresh copies)."""
    right = np.asarray(right)
    deleted = np.asarray(deleted)
    starts = np.asarray(starts)
    if right.dtype != np.int32 or starts.dtype != np.int32:
        raise TypeError("right and starts must be int32")
    if deleted.dtype != np.bool_:
        raise TypeError("deleted must be bool")
    if deleted.shape != right.shape or starts.shape[0] != right.shape[0]:
        raise ValueError("table shapes disagree")
    return tuple(
        torch.from_numpy(np.array(a, copy=True)).to(device)
        for a in (right, deleted, starts)
    )


def trim_tables(engine) -> list:
    """Per doc of ``engine`` (either package's ``BatchEngine``):
    ``(right[:n_rows], deleted[:n_rows], starts[:n_segs])`` as numpy
    arrays, or None for a doc served by the CPU core.  Works on torch
    tensors and on JAX arrays alike (both convert with ``np.asarray``
    after a host copy)."""
    if engine._right is None:
        return [None] * engine.n_docs
    right, deleted, starts = (
        _to_numpy(t) for t in (engine._right, engine._deleted, engine._starts)
    )
    out = []
    for i, m in enumerate(engine.mirrors):
        if i in engine.fallback:
            out.append(None)
            continue
        n, s = m.n_rows, m.n_segs
        out.append((right[i, :n].copy(), deleted[i, :n].copy(),
                    starts[i, :s].copy()))
    return out


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)
