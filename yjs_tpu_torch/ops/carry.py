"""Carry device state across from the JAX engine, and back out.

This system has no weights: a doc's state crosses between the packages
as wire bytes (its update log, or ``encode_state_as_update``), whose
format both packages share.  What is specific to a device is the three
resident tables and, on an engine that ran the levels/seq lanes, the six
resident static columns; this module moves those:

- :func:`tables_from_numpy` takes the JAX engine's tables (and statics)
  as numpy arrays (``np.asarray(eng._right)``, ``{k: np.asarray(v) for
  k, v in eng._statics.items()}``) and returns the port's tensors on
  ``device``;
- :func:`trim_tables` reads an engine's tables (and statics) back
  trimmed to each doc's live rows and segments — the format the parity
  tests compare, since capacity padding may differ between engines.

The JAX engine keeps ``client_key`` as uint32; the port keeps its bit
pattern in an int32 tensor (torch has no uint32 ``index_put_`` on the
CPU).  Both functions convert: trimmed statics carry ``client_key`` as
uint32 whichever engine they come from.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import STATIC_KEYS


def tables_from_numpy(right, deleted, starts, *, device, statics=None):
    """``(right [B, cap+1] i32, deleted [B, cap+1] bool, starts [B, S+1]
    i32)`` numpy arrays -> the same three tables as torch tensors on
    ``device`` (fresh copies).  With ``statics`` (a dict of the six
    ``[B, cap+1]`` columns, ``client_key`` uint32) a fourth element is
    the port's statics dict: int32 tensors, ``client_key`` as its bit
    pattern."""
    right = np.asarray(right)
    deleted = np.asarray(deleted)
    starts = np.asarray(starts)
    if right.dtype != np.int32 or starts.dtype != np.int32:
        raise TypeError("right and starts must be int32")
    if deleted.dtype != np.bool_:
        raise TypeError("deleted must be bool")
    if deleted.shape != right.shape or starts.shape[0] != right.shape[0]:
        raise ValueError("table shapes disagree")
    tables = tuple(
        torch.from_numpy(np.array(a, copy=True)).to(device)
        for a in (right, deleted, starts)
    )
    if statics is None:
        return tables
    cols = {}
    for key in STATIC_KEYS:
        a = np.asarray(statics[key])
        if a.shape != right.shape:
            raise ValueError(f"static column {key} does not match right")
        if key == "client_key":
            a = a.astype(np.uint32).view(np.int32)
        elif a.dtype != np.int32:
            raise TypeError(f"static column {key} must be int32")
        cols[key] = torch.from_numpy(np.array(a, copy=True)).to(device)
    return (*tables, cols)


def trim_tables(engine, statics: bool = False) -> list:
    """Per doc of ``engine`` (either package's ``BatchEngine``):
    ``(right[:n_rows], deleted[:n_rows], starts[:n_segs])`` as numpy
    arrays, or None for a doc served by the CPU core.  With ``statics``
    a fourth element holds the six static columns' first ``n_rows``
    entries (``client_key`` as uint32; None while the engine has no
    statics).  Works on torch tensors and on JAX arrays alike (both
    convert with ``np.asarray`` after a host copy)."""
    if engine._right is None:
        return [None] * engine.n_docs
    right, deleted, starts = (
        _to_numpy(t) for t in (engine._right, engine._deleted, engine._starts)
    )
    cols = None
    if statics and engine._statics is not None:
        cols = {k: _to_numpy(engine._statics[k]) for k in STATIC_KEYS}
        cols["client_key"] = cols["client_key"].view(np.uint32)
    out = []
    for i, m in enumerate(engine.mirrors):
        if i in engine.fallback:
            out.append(None)
            continue
        n, s = m.n_rows, m.n_segs
        doc = (right[i, :n].copy(), deleted[i, :n].copy(),
               starts[i, :s].copy())
        if statics:
            doc += (None if cols is None
                    else {k: v[i, :n].copy() for k, v in cols.items()},)
        out.append(doc)
    return out


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)
