"""Build-once cache for the port's shared libraries.

Every native library of the package (the g++ plan core, the nvcc
kernels) is compiled at first use into ``yjs_tpu_torch/_build/`` under a
name that carries a digest of its sources and its command line, so a
changed source can never load a stale binary.  Parallel processes (test
workers, one per core) serialise on a per-library file lock; the
compiler writes a temporary name that ``os.replace`` moves into place
atomically, so no process ever ``dlopen``s a half-written file.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def _digest(sources: list[str], cmd: list[str]) -> str:
    h = hashlib.sha256()
    for arg in cmd:
        h.update(arg.encode())
        h.update(b"\0")
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_shared(stem: str, sources: list[str], make_cmd, deps=(),
                 timeout: float = 600.0) -> tuple[str, bool, str]:
    """Path of ``stem``'s library, compiling it if no current build exists.

    ``make_cmd(out_path)`` returns the compiler argv writing ``out_path``
    (the sources are part of it).  ``deps`` are headers the digest must
    cover too.  Returns ``(path, built_now, compiler_output)``; raises
    ``subprocess.CalledProcessError`` when the compiler fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    key = _digest(list(sources) + list(deps), make_cmd("OUT"))
    path = os.path.join(BUILD_DIR, f"{stem}-{key}.so")
    if os.path.exists(path):
        return path, False, ""
    lock_path = os.path.join(BUILD_DIR, f".{stem}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):  # another process built it meanwhile
                return path, False, ""
            tmp = f"{path}.tmp{os.getpid()}"
            try:
                proc = subprocess.run(
                    make_cmd(tmp), check=True, capture_output=True,
                    timeout=timeout,
                )
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    out = (proc.stdout or b"").decode(errors="replace") + (
        proc.stderr or b""
    ).decode(errors="replace")
    return path, True, out
