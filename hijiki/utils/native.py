"""Build the native C++ helpers (plain C ABI, loaded with ctypes) from their
committed sources on first use.

The shared object is cached under the temp directory, keyed by a digest of
the source and the flags, so it is rebuilt only when either changes. A lock
serialises builds within a process (threads may load a helper at once) and a
per-process temporary name keeps concurrent processes from publishing a
half-written file.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_LOCK = threading.Lock()


def find_cxx() -> str | None:
    """A C++ compiler: ``$CXX``, else g++ / c++ / clang++ on PATH, else a
    target-prefixed or versioned g++ (e.g. ``x86_64-linux-gnu-g++-13``)."""
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    for d in os.environ.get("PATH", "").split(os.pathsep):
        for path in sorted(glob.glob(os.path.join(d, "*-g++*"))):
            if os.access(path, os.X_OK):
                return path
    return None


def shared_object(src: str, tag: str, flags: list) -> str:
    """Path of ``src`` compiled with ``flags`` into a shared object, building
    it first if needed. Raises RuntimeError with the compiler's message."""
    with open(src, "rb") as f:
        key = f.read() + b"\0" + " ".join(flags).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    cache = os.path.join(tempfile.gettempdir(), "hijiki_native")
    so = os.path.join(cache, f"{tag}_{digest}.so")
    with _LOCK:
        if os.path.exists(so):
            return so
        cxx = find_cxx()
        if cxx is None:
            raise RuntimeError("no C++ compiler found (set CXX)")
        os.makedirs(cache, exist_ok=True)
        tmp = f"{so}.tmp.{os.getpid()}"
        done = subprocess.run(
            [cxx, *flags, "-shared", "-fPIC", "-o", tmp, src],
            capture_output=True,
            text=True,
        )
        if done.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cxx)} failed on {src}: {done.stderr[-2000:]}")
        os.replace(tmp, so)
    return so
