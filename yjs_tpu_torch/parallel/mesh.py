"""The doc-sharded mesh: the doc batch split over devices.

The PyTorch port of ``yjs_tpu/parallel/mesh.py``.  Docs are independent,
so the mesh shards the doc-batch axis: shard ``s`` of a meshed engine
holds docs ``[s * B_loc, (s + 1) * B_loc)`` in tensors on its device and
runs the kernels on them there.  The only cross-shard traffic is the
sum of the progress counters (the reference's ``psum``, by
:func:`..ops.kernels.shard_fold`) and, on a ``("docs", "rows")`` mesh,
the maximum of the state vectors over the row shards (its ``pmax``): the
row shards on one device meet in one output by ``atomicMax``, and only
partials on distinct devices go through the fold.

The reference's mesh is single-controller: one process drives every
device through ``shard_map``.  So is this one.  A :class:`DocMesh` is an
array of torch devices with named axes, and one process launches the
shards' kernels, device by device, on each device's current stream.
Shards may share a device: the CPU tests run eight shards on the CPU, as
the reference's tests run eight virtual host devices, and one card can
hold four.  Distinct GPUs are the same code with a device per shard.

Axes:

- ``docs``: the data-parallel axis; every ``[B, ...]`` array is split on
  its leading dim.
- ``rows`` (optional, 2-D mesh): the item-table axis of the reduction
  kernels (state vectors by per-shard segment max, then the max over the
  row shards), the long-document analogue of sequence parallelism.

Each ``sharded_*`` factory returns a callable, wrapped by ``profiled``
under the reference's name.  The apply (K14) and level (K15) steps make
one launch a device for all its shards, whose
tensors travel to the kernel by value, and so do the state vectors (K16).
Each counts its launches in ``kernels.launches``.  With
``plain=True`` the callable runs the kernels' plain PyTorch versions
instead, on whatever device the tensors lie.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.prof import profiled

# ..ops.kernels is imported inside the functions: the engine imports this
# module while the ops package initialises


class DocMesh:
    """An array of torch devices with named axes, the reference's
    ``jax.sharding.Mesh`` as this package uses it: ``devices`` (a numpy
    object array of ``torch.device``; ``devices.size`` counts shards),
    ``axis_names`` and ``shape`` (axis name -> size).  A device may
    appear more than once."""

    def __init__(self, devices, axis_names=("docs",)):
        arr = np.array(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(
                f"devices of shape {arr.shape} do not fit the axes "
                f"{axis_names}"
            )
        flat = np.empty(arr.size, dtype=object)
        for k, d in enumerate(arr.flat):
            flat[k] = _resolve(d)
        self.devices = flat.reshape(arr.shape)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))

    def axis_devices(self, axis: str | None = None) -> list[torch.device]:
        """The devices along ``axis`` (the first axis by default), at
        index 0 of the other axes: the shards of a doc-sharded engine."""
        ax = self.axis_names.index(axis or self.axis_names[0])
        idx = [0] * self.devices.ndim
        idx[ax] = slice(None)
        return list(self.devices[tuple(idx)])

    def __repr__(self) -> str:
        return (f"DocMesh({self.shape}, "
                f"{sorted({str(d) for d in self.devices.flat})})")


def _resolve(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _cuda_devices() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _backend_devices(backend: str | None) -> list[torch.device]:
    if backend == "cpu":
        return [torch.device("cpu")]
    if backend not in (None, "cuda", "gpu"):
        raise ValueError(f"unknown backend {backend!r}")
    return _cuda_devices()


def doc_mesh(
    n_devices: int | None = None, axis: str = "docs",
    backend: str | None = None,
) -> DocMesh:
    """A 1-D mesh over the doc-batch axis.

    ``backend="cpu"`` gives ``n_devices`` shards (one by default) that
    all lie on the CPU, where the kernels' plain versions serve: the CPU
    counterpart of the reference's virtual host mesh.  Otherwise the
    mesh is the first ``n_devices`` CUDA devices (all of them by
    default), and ``ValueError`` says when there are fewer."""
    if backend == "cpu":
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"a mesh needs a device, got {n_devices}")
        return DocMesh([torch.device("cpu")] * n, (axis,))
    devs = _backend_devices(backend)
    want = len(devs) if n_devices is None else n_devices
    if want < 1 or len(devs) < want:
        raise ValueError(
            f"requested {n_devices} devices, backend has {len(devs)}"
        )
    return DocMesh(devs[:want], (axis,))


def shard_meshes(
    n_shards: int,
    axis: str = "docs",
    backend: str | None = None,
    devices_per_shard: int | None = None,
) -> list[DocMesh | None]:
    """Partition the device list into per-shard 1-D doc meshes (the
    fleet's device-placement map: shard ``k`` of a fleet runs its engine
    over mesh ``k``).  Devices are dealt out contiguously.  When there
    are fewer devices than shards, every entry is ``None``: the fleet then
    runs unmeshed on the default device (a single-card host)."""
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    devs = _backend_devices(backend)
    if devices_per_shard is None:
        devices_per_shard = len(devs) // n_shards
    if devices_per_shard < 1 or len(devs) < n_shards * devices_per_shard:
        return [None] * n_shards
    return [
        DocMesh(devs[k * devices_per_shard : (k + 1) * devices_per_shard],
                (axis,))
        for k in range(n_shards)
    ]


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def shard_rows(x, devices) -> list[torch.Tensor]:
    """Split a host array (numpy, or a CPU tensor) on its leading axis
    into ``len(devices)`` equal blocks, each placed on its device: a view
    on the CPU, a ``non_blocking`` copy from pinned memory on CUDA (the
    caching host allocator keeps the pinned copy until the transfer has
    read it)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x)
    )
    n = len(devices)
    if t.shape[0] % n:
        raise ValueError(
            f"leading axis {t.shape[0]} is not a multiple of {n} shards"
        )
    b = t.shape[0] // n
    if any(d.type == "cuda" for d in devices) and t.device.type == "cpu":
        t = t.contiguous().pin_memory()
    return [
        t[s * b : (s + 1) * b] if d == t.device
        else t[s * b : (s + 1) * b].to(d, non_blocking=True)
        for s, d in enumerate(devices)
    ]


def put_host(x, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: a view on the CPU, a ``non_blocking``
    copy from pinned memory on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _placed(x, devices) -> list:
    """Per-shard tensors as given, or a host array split over the shards."""
    if isinstance(x, (list, tuple)):
        if len(x) != len(devices):
            raise ValueError(f"{len(x)} blocks for {len(devices)} shards")
        return list(x)
    return shard_rows(x, devices)


def _zero_counters(dyn) -> list[torch.Tensor]:
    """Each shard's zeroed ``[2]`` int32 progress counter: one ``[S_dev,
    2]`` block a device, zeroed once, whose rows go to its shards."""
    from ..ops import kernels

    out = [None] * len(dyn)
    groups = kernels._device_groups([t[0].device for t in dyn])
    for dev, shards in groups.items():
        block = torch.zeros((len(shards), 2), dtype=torch.int32, device=dev)
        for row, s in zip(block, shards):
            out[s] = row
    return out


def fold_metrics(counters, plain: bool = False) -> dict:
    """The global progress counters of a sharded step: the per-shard
    ``[2]`` int32 counters (rows of :func:`_zero_counters`' blocks)
    summed by :func:`kernels.shard_fold` (the reference's ``psum``), read
    back to ``{"integrated", "deleted"}``."""
    from ..ops import kernels

    fold = kernels.shard_fold_plain if plain else kernels.shard_fold
    integrated, deleted = (int(v) for v in fold(counters, "sum").tolist())
    return {"integrated": integrated, "deleted": deleted}


# ---------------------------------------------------------------------------
# the sharded kernels
# ---------------------------------------------------------------------------


def sharded_batch_step(mesh: DocMesh, axis: str = "docs",
                       plain: bool = False):
    """The level-parallel YATA step sharded over the doc axis (K15).

    Returns ``fn(statics, dyn, splits, lv_sched, delete_rows,
    scratch_base, counters=None) -> (dyn, counters)``: every shard's
    statics dict and tables (in place) stepped with its blocks of the
    ``[B, ...]`` schedules (host arrays, split here, or per-shard
    tensors), counting into the shard's ``[2]`` int32 counter its
    schedule lanes with a row and its delete rows; one launch a device
    (:func:`kernels.sharded_batch_step_levels`).  ``counters`` from an
    earlier call carry on (a flush's level blocks add up); None starts
    from zero.  :func:`fold_metrics` folds them."""
    from ..ops import kernels

    devices = mesh.axis_devices(axis)

    def run(statics, dyn, splits, lv_sched, delete_rows, scratch_base,
            counters=None):
        dyn = _placed(dyn, devices)
        statics = _placed(statics, devices)
        blocks = [_placed(a, devices)
                  for a in (splits, lv_sched, delete_rows, scratch_base)]
        if counters is None:
            counters = _zero_counters(dyn)
        if plain:
            for s, tabs in enumerate(dyn):
                kernels.batch_step_levels_plain(
                    statics[s], tabs, *(blk[s] for blk in blocks),
                    counter=counters[s])
        else:
            kernels.sharded_batch_step_levels(statics, dyn, *blocks,
                                              counters)
        return dyn, counters

    return run if plain else profiled("sharded_batch_step")(run)


def sharded_apply_plan(mesh: DocMesh, axis: str, k_dn: int, k_sp: int,
                       k_h: int, k_d: int, plain: bool = False):
    """The bulk-apply flush sharded over the doc axis (K14): each shard
    scatters its own lanes row into its tables, in place.

    Returns ``fn(dyn, lanes) -> (dyn, counters)``.  ``lanes`` is ``[n_shards,
    4*B_loc + k_dn + 2*k_sp + 2*k_h + k_d]`` i32 or i16 (a host array,
    one row placed on each shard, or the per-shard rows); ``dyn`` holds
    each shard's ``(right, deleted, starts)``.  Each shard's ``[2]`` int32
    counter holds its dense plus sparse counts and its delete counts, the
    totals of the count scan.  One launch a device
    (:func:`kernels.sharded_apply_lanes`)."""
    from ..ops import kernels

    devices = mesh.axis_devices(axis)
    widths = (k_dn, k_sp, k_h, k_d)

    def run(dyn, lanes):
        dyn = _placed(dyn, devices)
        rows = (list(lanes) if isinstance(lanes, (list, tuple))
                else [r[0] for r in shard_rows(lanes, devices)])
        counters = _zero_counters(dyn)
        if plain:
            for tabs, row, c in zip(dyn, rows, counters):
                kernels.apply_lanes_plain(tabs, row, *widths, counter=c)
        else:
            kernels.sharded_apply_lanes(dyn, rows, widths, counters)
        return dyn, counters

    return run if plain else profiled("sharded_apply_plan")(run)


def _grid(mesh: DocMesh, axis: str, row_axis: str | None) -> list:
    """``grid[d][r]``: the device of doc shard ``d`` and row shard ``r``
    (index 0 on any other axis; one row shard without ``row_axis``)."""
    ax = mesh.axis_names.index(axis)
    rx = None if row_axis is None else mesh.axis_names.index(row_axis)
    n_row = 1 if rx is None else mesh.devices.shape[rx]
    grid = []
    for d in range(mesh.devices.shape[ax]):
        row = []
        for r in range(n_row):
            idx = [0] * mesh.devices.ndim
            idx[ax] = d
            if rx is not None:
                idx[rx] = r
            row.append(mesh.devices[tuple(idx)])
        grid.append(row)
    return grid


def state_vector_blocks(mesh: DocMesh, x, axis: str = "docs",
                        row_axis: str | None = None) -> list:
    """A host ``[B, N]`` array cut into the blocks of
    :func:`sharded_state_vectors`: ``blocks[d][r]``, doc block ``d``'s
    column block ``r``, on its shard's device."""
    grid = _grid(mesh, axis, row_axis)
    h = np.asarray(x, np.int32)
    b, n = h.shape
    if b % len(grid) or n % len(grid[0]):
        raise ValueError(
            f"[{b}, {n}] does not split over a {len(grid)} x {len(grid[0])} "
            "mesh"
        )
    bd, nr = b // len(grid), n // len(grid[0])
    return [
        [put_host(h[d * bd : (d + 1) * bd, r * nr : (r + 1) * nr], dev)
         for r, dev in enumerate(row)]
        for d, row in enumerate(grid)
    ]


def state_vector_layout(mesh: DocMesh, b: int, n: int, axis: str = "docs",
                        row_axis: str | None = None) -> dict:
    """Where :func:`sharded_state_vectors` puts host ``[B, N]`` arrays:
    ``{device: (held, shards)}``.  Each device gets one copy of the doc
    rows it holds, ``held`` (doc blocks, in order, their rows stacked);
    each of its shards is a tuple ``(d, r, offset, row_stride, docs, cols,
    out_row)``: doc block ``d``'s column block ``r`` starts at int32
    ``offset`` of that copy (of either column), its rows ``row_stride``
    apart, and its state vectors go to the device's output from row
    ``out_row`` on (:func:`..ops.kernels.state_vector_groups`).  The
    blocks are those :func:`state_vector_blocks` cuts; a ``[B, N]`` that
    does not split over the mesh raises ``ValueError``."""
    from ..ops import kernels

    grid = _grid(mesh, axis, row_axis)
    if b % len(grid) or n % len(grid[0]):
        raise ValueError(
            f"[{b}, {n}] does not split over a {len(grid)} x {len(grid[0])} "
            "mesh"
        )
    bd, nr = b // len(grid), n // len(grid[0])
    groups = kernels.state_vector_groups(grid, [bd] * len(grid))
    return {
        dev: (list(held), [(d, r, held[d] * n + r * nr, n, bd, nr, held[d])
                           for d, r in shards])
        for dev, (held, shards) in groups.items()
    }


def _host_blocks(mesh: DocMesh, row_slot, row_end, axis: str,
                 row_axis: str | None) -> tuple[list, list]:
    """Host ``[B, N]`` arrays as ``blocks[d][r]`` views of one copy a
    device of the doc rows it holds (:func:`state_vector_layout`): on
    CUDA one pinned buffer of both columns and one ``non_blocking`` copy;
    on the CPU views of the arrays where the held rows are consecutive."""
    h = [torch.from_numpy(np.ascontiguousarray(x, np.int32))
         for x in (row_slot, row_end)]
    if h[0].dim() != 2 or h[0].shape != h[1].shape:
        raise ValueError("row_slot and row_end must be equal [B, N]")
    b, n = h[0].shape
    layout = state_vector_layout(mesh, b, n, axis, row_axis)
    grid = _grid(mesh, axis, row_axis)
    bd = b // len(grid)
    slots = [[None] * len(row) for row in grid]
    ends = [[None] * len(row) for row in grid]
    for dev, (held, shards) in layout.items():
        lo, hi = held[0] * bd, (held[-1] + 1) * bd
        if dev.type == "cpu" and hi - lo == len(held) * bd:
            cols = [x[lo:hi] for x in h]
        else:
            # torch's copy fills the pinned buffer on several threads
            host = torch.empty((2, len(held) * bd, n), dtype=torch.int32,
                               pin_memory=dev.type == "cuda")
            for k, d in enumerate(held):
                for c in range(2):
                    host[c, k * bd : (k + 1) * bd].copy_(
                        h[c][d * bd : (d + 1) * bd])
            both = host if dev.type == "cpu" else host.to(dev,
                                                          non_blocking=True)
            cols = [both[0], both[1]]
        for d, r, offset, stride, docs, width, _row in shards:
            for col, out in zip(cols, (slots, ends)):
                out[d][r] = col.as_strided((docs, width), (stride, 1),
                                           col.storage_offset() + offset)
    return slots, ends


def sharded_state_vectors(mesh: DocMesh, n_slots: int, axis: str = "docs",
                          row_axis: str | None = None, plain: bool = False):
    """State vectors over a sharded doc batch (K16): ``fn(row_slot,
    row_end) -> [B, n_slots]`` int32 on the mesh's first device, from
    host ``[B, N]`` arrays split over ``axis`` (and, with ``row_axis``,
    their rows over ``row_axis``), or from their placed
    :func:`state_vector_blocks`.  The shards of a device reduce into one
    output in one launch (:func:`..ops.kernels.sharded_state_vector`;
    host arrays reach each device as one copy of the rows it holds,
    :func:`state_vector_layout`): on a 2-D mesh the row shards' maxima
    meet there, the reference's ``pmax``, the segment max of
    StructStore.getStateVector (StructStore.js:49-56).  With ``plain``,
    each shard runs :func:`..ops.kernels.state_vector_kernel_plain` on its
    block and the row shards of a doc block fold by
    :func:`..ops.kernels.shard_fold_plain` onto the first of them."""
    from ..ops import kernels

    first = _grid(mesh, axis, row_axis)[0][0]

    def run(row_slot, row_end):
        placed = isinstance(row_slot, (list, tuple))
        if not plain:
            if not placed:
                row_slot, row_end = _host_blocks(mesh, row_slot, row_end,
                                                 axis, row_axis)
            return kernels.sharded_state_vector(row_slot, row_end, n_slots)
        if not placed:
            if np.shape(row_slot) != np.shape(row_end):
                raise ValueError("row_slot and row_end must be equal [B, N]")
            row_slot = state_vector_blocks(mesh, row_slot, axis, row_axis)
            row_end = state_vector_blocks(mesh, row_end, axis, row_axis)
        out = []
        for slot_r, end_r in zip(row_slot, row_end):
            parts = [kernels.state_vector_kernel_plain(s, e, n_slots)
                     for s, e in zip(slot_r, end_r)]
            out.append(parts[0] if len(parts) == 1
                       else kernels.shard_fold_plain(parts, "max"))
        return torch.cat([o.to(first) for o in out])

    return run if plain else profiled("sharded_state_vectors")(run)
