"""The field kernels of the port and their plain PyTorch versions.

Each wrapper here stands in for one Pallas kernel of
``zkfhe_tpu/ops/pallas_field.py``:

    mont_mul  <- _mont_mul_kernel   (mont_mul_pallas)
    add       <- _add_kernel        (add_pallas)
    sub       <- _sub_kernel        (sub_pallas)
    bfly_dif  <- _bfly_dif_kernel   (butterfly_dif_pallas)
    bfly      <- _bfly_kernel       (butterfly_pallas)

On a CUDA tensor a wrapper launches the hand-written kernel of
``csrc/field_kernels.cu`` or raises; it never falls back. The same library
holds the modular matmul's kernels (``csrc/mxu_kernels.cu``), whose wrappers
are in ``mxu_field.py``. On any other
device (the CPU in tests) it runs the plain version, which is also the
kernel's oracle on the card.

The plain versions compute in int64 lanes (PyTorch's CPU kernels have no
uint32 add, shift or compare). They pack the 13-bit limbs into wider words so that
each field op is a few dozen tensor ops: 26-bit words for the Montgomery
product (products of 52 bits, sums of ten below 2^57), 52-bit words for
carries and the conditional subtract. Inputs are canonical (< p), so the
results equal the kernels' limb for limb.

Every kernel launch adds one to ``LAUNCHES[name]``; nothing else does.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from . import field as F

L = F.NLIMBS
MASK13 = F.LIMB_MASK
MASK26 = (1 << 26) - 1
MASK52 = (1 << 52) - 1

KERNELS = ("mont_mul", "add", "sub", "bfly_dif", "bfly")
LAUNCHES = {k: 0 for k in KERNELS}
# (shape, field) of each kernel's largest launch since the last reset
LARGEST = {k: None for k in KERNELS}

_FIELD_INDEX = {F.BN254_FR: 0, F.BN254_FQ: 1}


def reset_counts():
    for k in KERNELS:
        LAUNCHES[k] = 0
        LARGEST[k] = None


# ---------------------------------------------------------------------------
# Plain versions (int64 lanes)
# ---------------------------------------------------------------------------

_SH4 = (0, 13, 26, 39)


_CONSTS = {}


def _consts(field, device):
    """Packed constants of a field on a device (cached)."""
    key = (field.p, device)
    if key not in _CONSTS:
        p = field.p
        mu26 = (-pow(p, -1, 1 << 26)) % (1 << 26)
        p26 = [(p >> (26 * i)) & MASK26 for i in range(10)]
        p52 = [(p >> (52 * i)) & MASK52 for i in range(5)]
        _CONSTS[key] = dict(
            mu26=mu26,
            p26=torch.tensor(p26, dtype=torch.int64, device=device),
            p52=p52,
            p52t=torch.tensor(p52, dtype=torch.int64, device=device),
            sh4=torch.tensor(_SH4, dtype=torch.int64, device=device),
        )
    return _CONSTS[key]


def _pack26(a):
    """(2k, *B) 13-bit limbs -> (k, *B) int64 26-bit words."""
    x = a.to(torch.int64).reshape((a.shape[0] // 2, 2) + a.shape[1:])
    return x[:, 0] + (x[:, 1] << 13)


def _pack52(a, sh4):
    """(20, *B) 13-bit limbs -> (5, *B) int64 52-bit words."""
    x = a.to(torch.int64).reshape((5, 4) + a.shape[1:])
    return (x << sh4.reshape((1, 4) + (1,) * (a.dim() - 1))).sum(1)


def _unpack52(w, sh4):
    """(5, *B) normalised 52-bit words -> (20, *B) int32 13-bit limbs."""
    x = (w.unsqueeze(1) >> sh4.reshape((1, 4) + (1,) * (w.dim() - 1))) \
        & MASK13
    return x.reshape((20,) + w.shape[1:]).to(torch.int32)


def _norm52(w):
    """Carry-normalise (5, *B) non-negative words below 2^62."""
    out = []
    c = None
    for j in range(5):
        v = w[j] if c is None else w[j] + c
        out.append(v & MASK52)
        c = v >> 52
    return torch.stack(out)


def _mod_p52(s, k):
    """(5, *B) normalised words of a value < 2p -> value mod p."""
    out = []
    borrow = None
    for j in range(5):
        d = s[j] - k["p52"][j] if borrow is None else s[j] - k["p52"][j] - borrow
        borrow = (d < 0).to(torch.int64)
        out.append(d + (borrow << 52))
    keep = (borrow != 0).unsqueeze(0)  # s < p
    return torch.where(keep, s, torch.stack(out))


def _redc26(t, k):
    """Montgomery reduction of (20, *B) 26-bit-radix words (any non-negative
    values below 2^57 per word, total < p*R) -> value * R^-1 mod p as
    (20, *B) int32 limbs."""
    mu, p26 = k["mu26"], k["p26"].reshape((10,) + (1,) * (t.dim() - 1))
    for r in range(10):
        tr = t[r]
        m = (tr & MASK26).mul_(mu).bitwise_and_(MASK26)
        t[r:r + 10].addcmul_(p26, m)
        t[r + 1].add_(tr >> 26)
    hi = t[10:20]
    # one parallel carry pass bounds every word below 2^32, so 26-bit
    # pairs combine into 52-bit words without overflowing int64. The carry
    # out of the top word is 0: the value is below 2p < 2^255.
    c = hi >> 26
    hi = hi & MASK26
    hi[1:] += c[:-1]
    w = hi[0::2] + (hi[1::2] << 26)
    return _unpack52(_mod_p52(_norm52(w), k), k["sh4"])


def plain_mont_mul(field, a, b):
    k = _consts(field, a.device)
    a26, b26 = _pack26(a), _pack26(b)
    batch = a.shape[1:]
    prods = a26.unsqueeze(1) * b26.unsqueeze(0)  # (10, 10, *B) < 2^52
    # t[s] = sum_{i+j=s} prods[i, j]: skew each row i right by i
    sk = torch.cat([prods, torch.zeros_like(prods)], dim=1)  # (10, 20, *B)
    sk = sk.reshape((200,) + batch)[:190].reshape((10, 19) + batch)
    t = torch.cat([sk.sum(0), torch.zeros((1,) + batch, dtype=torch.int64,
                                          device=a.device)])
    return _redc26(t, k)


def plain_mont_reduce(field, t):
    """(40, *B) 13-bit limbs (value < p*R) -> value * R^-1 mod p."""
    return _redc26(_pack26(t), _consts(field, t.device))


def plain_add(field, a, b):
    k = _consts(field, a.device)
    s = _norm52(_pack52(a, k["sh4"]) + _pack52(b, k["sh4"]))
    return _unpack52(_mod_p52(s, k), k["sh4"])


def plain_sub(field, a, b):
    k = _consts(field, a.device)
    wa, wb = _pack52(a, k["sh4"]), _pack52(b, k["sh4"])
    out = []
    borrow = None
    for j in range(5):
        d = wa[j] - wb[j] if borrow is None else wa[j] - wb[j] - borrow
        borrow = (d < 0).to(torch.int64)
        out.append(d + (borrow << 52))
    d = torch.stack(out)
    withp = _norm52(d + k["p52t"].reshape((5,) + (1,) * (d.dim() - 1)))
    res = torch.where((borrow != 0).unsqueeze(0), withp, d)
    return _unpack52(res, k["sh4"])


def plain_bfly_dif(field, u, v, tw):
    return plain_add(field, u, v), plain_mont_mul(field,
                                                  plain_sub(field, u, v), tw)


def plain_bfly(field, u, v, tw):
    vw = plain_mont_mul(field, v, tw)
    return plain_add(field, u, vw), plain_sub(field, u, vw)


# ---------------------------------------------------------------------------
# The CUDA library: built with nvcc at first use, loaded with ctypes
# ---------------------------------------------------------------------------

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
# the library's sources; their shared header enters the digest too
SOURCES = [os.path.join(_CSRC, f) for f in ("field_kernels.cu",
                                            "mxu_kernels.cu")]
HEADERS = [os.path.join(_CSRC, "field_device.cuh")]
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BUILD_DIR = os.path.join(_ROOT, "build")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = _ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                      "-v"]

_lib = None
_lib_lock = threading.Lock()
BUILD_LOG = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA field kernels cannot be "
                       "built (set CUDA_HOME)")


def library_path() -> str:
    """build/field_kernels-<digest>.so, the digest over every source and
    header and the flags, so that a change to any of them builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES + HEADERS:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"field_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/field_kernels.cu and csrc/mxu_kernels.cu, one nvcc
    process each, started together, and link them into one library in
    build/, unless the same sources were built already. Returns the library
    path; the compilers' output (with -Xptxas -v register counts) and each
    step's seconds are kept in BUILD_LOG."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{path[:-3]}.{os.getpid()}.{os.path.basename(src)[:-3]}.o"
            for src in SOURCES]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(SOURCES, objs)]

    def run(cmd):
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return proc.stdout + proc.stderr, proc.returncode, time.time() - t0
    try:
        with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
            outs = list(pool.map(run, cmds))
        if all(rc == 0 for _, rc, _ in outs):
            cmds.append([_nvcc(), *_ARCH, "-shared", "-o", tmp, *objs])
            outs.append(run(cmds[-1]))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    BUILD_LOG["cmd"] = "\n".join(" ".join(c) for c in cmds)
    BUILD_LOG["output"] = "".join(out for out, _, _ in outs)
    BUILD_LOG["seconds"] = {
        step: round(dt, 3) for step, (_, _, dt) in zip(
            [os.path.basename(src) for src in SOURCES] + ["link"], outs)}
    if any(rc != 0 for _, rc, _ in outs):
        raise RuntimeError(f"nvcc failed:\n{BUILD_LOG['cmd']}\n"
                           f"{BUILD_LOG['output']}")
    os.replace(tmp, path)
    return path


def load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name in ("zk_mont_mul", "zk_add", "zk_sub"):
            fn = getattr(lib, name)
            fn.argtypes = [i32, vp, vp, vp, i64, vp]
            fn.restype = i32
        for name in ("zk_bfly_dif", "zk_bfly"):
            fn = getattr(lib, name)
            fn.argtypes = [i32, vp, vp, vp, vp, vp, i64, vp]
            fn.restype = i32
        lib.zk_field_params.argtypes = [i32, ctypes.POINTER(ctypes.c_uint32)]
        lib.zk_field_params.restype = i32
        for fld, idx in ((F.FR, 0), (F.FQ, 1)):
            buf = (ctypes.c_uint32 * (L + 1))()
            if lib.zk_field_params(idx, buf) != 0:
                raise RuntimeError("field kernel library lacks a field")
            if tuple(buf[:L]) != fld.p_limbs or buf[L] != fld.mu:
                raise RuntimeError(f"field kernel constants differ from "
                                   f"{fld.name}")
        # the modular matmul's kernels (wrappers in mxu_field.py)
        lib.zk_planes7.argtypes = [vp] + [i64] * 10 + [vp, vp]
        lib.zk_plane_mm_redc.argtypes = [i32, vp, vp] + [i64] * 12 + [vp] * 4
        lib.zk_mxu_params.argtypes = [ctypes.POINTER(ctypes.c_uint32)]
        for name in ("zk_planes7", "zk_plane_mm_redc", "zk_mxu_params"):
            getattr(lib, name).restype = i32
        buf = (ctypes.c_uint32 * L)()
        lib.zk_mxu_params(buf)
        if tuple(buf) != tuple(int(v) for v in F.int_to_limbs(
                pow(2, F.LIMB_BITS * (2 * L - 1), F.FR.p))):
            raise RuntimeError("matmul kernel constants differ from Fr")
        _lib = lib
        return lib


def field_index(field) -> int:
    try:
        return _FIELD_INDEX[field.p]
    except KeyError:
        raise ValueError(f"no CUDA field kernel for modulus {field.p}")


def _check(name, *xs):
    shape = xs[0].shape
    for x in xs:
        if x.dtype != torch.int32:
            raise TypeError(f"{name}: limbs must be int32, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"{name}: shapes differ {tuple(x.shape)} vs "
                             f"{tuple(shape)}")
        if x.device != xs[0].device:
            raise ValueError(f"{name}: operands on different devices")
        if not x.is_cuda or x.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: operands must be on the current CUDA "
                             f"device, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if len(shape) < 1 or shape[0] != L:
        raise ValueError(f"{name}: leading axis must be {L} limbs, got "
                         f"{tuple(shape)}")


def _launch(name, rc, field, x):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1
    big = LARGEST[name]
    if big is None or x.numel() > big[0].numel():
        LARGEST[name] = (x.shape, field)


def _lanes(x) -> int:
    return x.numel() // L


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def cuda_binary(name, field, a, b):
    """Launch one of the binary kernels on contiguous int32 CUDA operands."""
    _check(name, a, b)
    lib = load()
    out = torch.empty_like(a)
    n = _lanes(a)
    fn = getattr(lib, "zk_" + name)
    _launch(name, fn(field_index(field), a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), n, stream()), field, a)
    return out


def cuda_butterfly(name, field, u, v, tw):
    """Launch bfly_dif or bfly; both outputs go to fresh caller buffers."""
    _check(name, u, v, tw)
    lib = load()
    hi, lo = torch.empty_like(u), torch.empty_like(u)
    n = _lanes(u)
    fn = getattr(lib, "zk_" + name)
    _launch(name, fn(field_index(field), u.data_ptr(), v.data_ptr(),
                     tw.data_ptr(), hi.data_ptr(), lo.data_ptr(), n,
                     stream()), field, u)
    return hi, lo


# ---------------------------------------------------------------------------
# Wrappers: the only entry points the port's modules call
# ---------------------------------------------------------------------------

_PLAIN = {"mont_mul": plain_mont_mul, "add": plain_add, "sub": plain_sub}

# lanes per call of the plain Montgomery product on the CPU: its (10, 20,
# lanes) int64 intermediates fall out of the cache beyond a few thousand
# lanes, and chunking halves its time at 30k-150k lanes (same results)
CPU_CHUNK = 8192


def _binary(name, field, a, b):
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    if a.is_cuda or b.is_cuda:
        return cuda_binary(name, field, a.contiguous(), b.contiguous())
    lanes = _lanes(a)
    if name == "mont_mul" and lanes > 2 * CPU_CHUNK:
        a2, b2 = a.reshape(L, lanes), b.reshape(L, lanes)
        return torch.cat([plain_mont_mul(field, a2[:, i:i + CPU_CHUNK],
                                         b2[:, i:i + CPU_CHUNK])
                          for i in range(0, lanes, CPU_CHUNK)],
                         dim=1).reshape(a.shape)
    return _PLAIN[name](field, a, b)


def mont_mul(field, a, b):
    return _binary("mont_mul", field, a, b)


def add(field, a, b):
    return _binary("add", field, a, b)


def sub(field, a, b):
    return _binary("sub", field, a, b)


def _butterfly(name, field, u, v, tw):
    u, v, tw = torch.broadcast_tensors(u, v, tw)
    if u.is_cuda or v.is_cuda or tw.is_cuda:
        return cuda_butterfly(name, field, u.contiguous(), v.contiguous(),
                              tw.contiguous())
    plain = plain_bfly_dif if name == "bfly_dif" else plain_bfly
    return plain(field, u, v, tw)


def bfly_dif(field, u, v, tw):
    """(u + v, (u - v) * tw) mod p; tw broadcasts to u's shape."""
    return _butterfly("bfly_dif", field, u, v, tw)


def bfly(field, u, v, tw):
    """(u + v * tw, u - v * tw) mod p; tw broadcasts to u's shape."""
    return _butterfly("bfly", field, u, v, tw)
