"""The host libraries of ``native/``, built from their sources at first use.

``make -C native <lib>`` runs under an exclusive file lock, so concurrent
processes (test workers, loader threads) build each library once. Where
the build cannot run (no ``make`` or compiler), the callers keep their
NumPy fallbacks.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import warnings
from typing import Optional

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
)


def native_lib(name: str) -> Optional[str]:
    """Path of ``native/<name>``, building it if it is missing; None if it
    cannot be built here."""
    path = os.path.join(NATIVE_DIR, name)
    if os.path.exists(path):
        return path
    if shutil.which("make") is None or not os.path.exists(os.path.join(NATIVE_DIR, "Makefile")):
        return None
    with open(os.path.join(NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(path):
            result = subprocess.run(
                ["make", "-C", NATIVE_DIR, name], capture_output=True, text=True
            )
            if result.returncode != 0:
                warnings.warn(f"building native/{name} failed:\n{result.stderr[-2000:]}")
    return path if os.path.exists(path) else None
