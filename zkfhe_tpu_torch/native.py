"""ctypes loader for the native verifier core (port of
zkfhe_tpu/native/__init__.py).

``native/zkfhe_native.cc`` (a top-level source of the repository, shared
with the JAX package) holds a BN254 G1 Pippenger MSM and the optimal-ate
pairing check. This loader builds it with ``g++ -O3`` into ``build/`` at
first use, keyed by a hash of the source, and loads it. If the build or
the load fails (no ``g++`` on the host, say), ``get_lib`` prints one line
to stderr and returns None, and ``msm`` and ``pairing_check`` return None:
the verifier then runs its python-int versions
(``ops/msm.msm_host_pippenger``, ``backend/pairing.pairing_check``), as
the JAX package's does. A failed call of a loaded library still raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

from .ops.curve import AffinePoint
from .ops.field import BN254_FQ

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_ROOT, "native", "zkfhe_native.cc")
BUILD_DIR = os.path.join(_ROOT, "build")

_lib = None
_tried = False
_lock = threading.Lock()


def _build() -> str:
    with open(SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libzkfhe_native-{tag}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SRC],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"native build failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, path)
    return path


def _load():
    lib = ctypes.CDLL(_build())
    lib.zk_init.argtypes = [ctypes.c_char_p]
    lib.zk_init.restype = ctypes.c_int
    lib.zk_msm.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                           ctypes.c_char_p, ctypes.c_uint64,
                           ctypes.c_char_p]
    lib.zk_msm.restype = ctypes.c_int
    lib.zk_pairing_check.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_uint64]
    lib.zk_pairing_check.restype = ctypes.c_int
    rc = lib.zk_init(int(BN254_FQ).to_bytes(32, "little"))
    if rc != 0:
        raise RuntimeError(f"zk_init failed rc={rc}")
    return lib


def get_lib():
    """The loaded native library (built on first use), or None when it
    cannot be built or loaded; the first attempt's outcome is kept."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _load()
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                # no g++, a failed compile or load: python versions take over
                print(f"[zkfhe_tpu_torch] native core unavailable ({e}); "
                      "using python fallbacks", file=sys.stderr)
                _lib = None
        return _lib


def msm(points, scalars) -> AffinePoint | None:
    """sum_i scalars[i] * points[i] over AffinePoint / int lists, or None
    when the native core is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(points)
    pts = bytearray(64 * n)
    infs = bytearray(n)
    scs = bytearray(32 * n)
    for i, (p, s) in enumerate(zip(points, scalars)):
        if p.infinity:
            infs[i] = 1
        else:
            pts[64 * i:64 * i + 32] = int(p.x).to_bytes(32, "little")
            pts[64 * i + 32:64 * i + 64] = int(p.y).to_bytes(32, "little")
        scs[32 * i:32 * i + 32] = int(s).to_bytes(32, "little")
    out = ctypes.create_string_buffer(65)
    rc = lib.zk_msm(bytes(pts), bytes(infs), bytes(scs), n, out)
    if rc != 0:
        raise RuntimeError(f"native msm failed rc={rc}")
    raw = out.raw
    if raw[64]:
        return AffinePoint()
    return AffinePoint(int.from_bytes(raw[:32], "little"),
                       int.from_bytes(raw[32:64], "little"))


def pairing_check(pairs) -> bool | None:
    """prod e(P_i, Q_i) == 1 for [(AffinePoint, g2 tuple or None)], or None
    when the native core is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    k = len(pairs)
    g1 = bytearray(64 * k)
    g1inf = bytearray(k)
    g2 = bytearray(128 * k)
    g2inf = bytearray(k)
    for i, (p, q) in enumerate(pairs):
        if p.infinity:
            g1inf[i] = 1
        else:
            g1[64 * i:64 * i + 32] = int(p.x).to_bytes(32, "little")
            g1[64 * i + 32:64 * i + 64] = int(p.y).to_bytes(32, "little")
        if q is None:
            g2inf[i] = 1
        else:
            (x0, x1), (y0, y1) = q
            g2[128 * i:128 * i + 32] = int(x0).to_bytes(32, "little")
            g2[128 * i + 32:128 * i + 64] = int(x1).to_bytes(32, "little")
            g2[128 * i + 64:128 * i + 96] = int(y0).to_bytes(32, "little")
            g2[128 * i + 96:128 * i + 128] = int(y1).to_bytes(32, "little")
    rc = lib.zk_pairing_check(bytes(g1), bytes(g1inf), bytes(g2),
                              bytes(g2inf), k)
    return bool(rc)
