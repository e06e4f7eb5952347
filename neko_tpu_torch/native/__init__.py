"""Native (C) host-side packing kernels, loaded through ctypes (counterpart
of neko_tpu/native/__init__.py; `packing.c` is this package's own copy).

`lib()` compiles `packing.c` at first use with the system C compiler
(`$CC`, else Python's configured compiler, else `cc`) into
`neko_tpu_torch/_build/` (listed in .gitignore), keyed by a hash of the
source and the flags, under a lock that holds across threads and processes,
and returns the loaded library.  Unlike the JAX package, a failed build
raises with the compiler's output: the packer never falls back to its numpy
route without a word.  `calls` counts the packs the library did
(`SequencePacker._pack_control_native`).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "packing.c"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# no fused multiply-add: the bins must equal the numpy route's bit for bit
CFLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
calls = 0


class NativeBuildError(RuntimeError):
    """The C compiler could not build packing.c."""


def _compiler() -> str:
    cc = os.environ.get("CC") or sysconfig.get_config_var("CC") or "cc"
    return cc.split()[0]


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"packing-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile packing.c unless the hashed library exists.  -> its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "packing.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if so.exists():
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_compiler(), *CFLAGS, "-o", tmp, str(SRC), "-lm"]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
            except OSError as e:
                raise NativeBuildError(f"cannot run the C compiler ({' '.join(cmd)}): {e}") from e
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"the C compiler failed to build {SRC.name} (exit {proc.returncode}): "
                    f"{' '.join(cmd)}\n{(proc.stdout + proc.stderr)[-4000:]}")
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def lib() -> ctypes.CDLL:
    """The loaded native library (built at the first call); raises
    NativeBuildError when the compiler fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            L = ctypes.CDLL(str(build()))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            c, cf = ctypes.c_int, ctypes.c_float
            L.pack_continuous_control.restype = c
            L.pack_continuous_control.argtypes = [
                f32p, c, c, f32p, c, cf, cf, c, c, c, i32p, u8p, i32p,
            ]
            L.pack_discrete_control.restype = c
            L.pack_discrete_control.argtypes = [
                i32p, c, c, i32p, c, c, c, i32p, u8p, i32p,
            ]
            L.pack_continuous_obs_discrete_act.restype = c
            L.pack_continuous_obs_discrete_act.argtypes = [
                f32p, c, c, i32p, c, cf, cf, c, c, c, c, i32p, u8p, i32p,
            ]
            _LIB = L
    return _LIB
