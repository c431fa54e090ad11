"""Doc-free batch update ops over struct-of-arrays columns.

The SURVEY version caveat (SURVEY.md "Version caveat") requires first-class
``mergeUpdates`` / ``diffUpdate``-style batch APIs even though v13.4.9
lacks them.  ``yjs_tpu.updates`` provides the semantic oracle by replaying
into a scratch :class:`~yjs_tpu.core.Doc`; the versions here run the same
contract through the columnar pipeline instead — native wire decode,
host causal schedule, native wire encode — touching no ``Doc``, no
``Item`` objects, and no payload bytes (zero-copy ranges) — measured
1.4-3x faster than the scratch-doc oracle depending on conflict density,
and the natural building block for server-side update laundering at
engine scale.

Semantics match the oracle exactly: updates are commutative/idempotent,
causally-incomplete structs are withheld from the output (the scratch-doc
oracle parks them in pending buffers and full-state encode skips them
too), and the DS section is the merged union.  Updates embedding
subdocuments (ContentDoc) fall back to the scratch-doc oracle internally
— same result, doc-level speed — mirroring the engine's gating seam.

Without the C++ plan core (no toolchain, ``YTPU_NO_NATIVE_PLAN=1``) the
columns are planned by the Python mirror, whose segment planner runs its
kernels on ``device``: the CUDA device by default, which raises
:class:`~.kernels.KernelError` without CUDA; ``device="cpu"`` runs their
plain PyTorch versions.
"""

from __future__ import annotations

from ..obs.prof import host_timed
from .columns import DocMirror, UnsupportedUpdate


def _loaded_mirror(updates: list[bytes], v2: bool, device):
    from .native_mirror import NativeMirror, native_plan_available

    m = (NativeMirror("") if native_plan_available()
         else DocMirror("", device=device))
    for u in updates:
        m.ingest(u, v2)
    m.prepare_step(want_levels=False)
    return m


@host_timed("merge_updates")
def merge_updates_columnar(
    updates: list[bytes], v2: bool = False, out_v2: bool | None = None,
    device=None,
) -> bytes:
    """Merge concurrent updates into one equivalent update, column-wise
    (the doc-free twin of :func:`yjs_tpu.updates.merge_updates`).

    ``v2`` selects the INPUT wire format; ``out_v2`` the output (defaults
    to the input format).  Mixing formats converts in one pass.
    """
    ov2 = v2 if out_v2 is None else out_v2
    try:
        m = _loaded_mirror(updates, v2, device)
    except UnsupportedUpdate:  # subdocuments: scratch-doc oracle
        from ..updates import convert_update_format, merge_updates

        merged = merge_updates(updates, v2=v2)
        return convert_update_format(merged, v2, ov2) if ov2 != v2 else merged
    return m.encode_state_as_update(v2=ov2)


@host_timed("diff_update")
def diff_update_columnar(
    update: bytes, encoded_state_vector: bytes, v2: bool = False,
    device=None,
) -> bytes:
    """What a peer at ``encoded_state_vector`` is missing from ``update``
    (the doc-free twin of :func:`yjs_tpu.updates.diff_update`)."""
    from ..updates import decode_state_vector

    try:
        m = _loaded_mirror([update], v2, device)
    except UnsupportedUpdate:  # subdocuments: scratch-doc oracle
        from ..updates import diff_update

        return diff_update(update, encoded_state_vector, v2=v2)
    return m.encode_state_as_update(
        decode_state_vector(encoded_state_vector), v2=v2
    )


@host_timed("encode_state_vector_from_update")
def encode_state_vector_from_update_columnar(
    update: bytes, v2: bool = False, device=None
) -> bytes:
    """The state vector an update would produce, without building a doc."""
    try:
        return _loaded_mirror([update], v2, device).encode_state_vector()
    except UnsupportedUpdate:  # subdocuments: scratch-doc oracle
        from ..updates import encode_state_vector_from_update

        return encode_state_vector_from_update(update, v2)
