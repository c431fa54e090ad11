"""Batch ops on torch: columnar transcoding + CUDA kernels + BatchEngine."""

from .batch import (  # noqa: F401
    diff_update_columnar,
    encode_state_vector_from_update_columnar,
    merge_updates_columnar,
)
from .columns import DocMirror, ItemRef, StepPlan, UnsupportedUpdate, decode_update_refs  # noqa: F401
from .engine import BatchEngine  # noqa: F401
