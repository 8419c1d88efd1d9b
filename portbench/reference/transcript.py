"""Blake2b Fiat-Shamir transcript + proof byte stream (frozen copy of the
port's backend/transcript.py).

Host-side orchestration of challenges (halo2-axiom uses a Blake2b
transcript — SURVEY.md §2.2 "Transcript"); all device kernels hand their
commitments/evals here. Serialization: points COMPRESSED to 32 bytes
(x LE with two flag bits in the top byte — BN254 Fq is 254 bits, so
bits 254/255 are free: bit 255 = y parity, bit 254 = infinity), scalars
as 32-byte LE. The proof is the exact byte stream the prover wrote; the
verifier reads and absorbs in the same order.

Deserialization is strict:
x must be canonical (< q) and x^3 + 3 must be a quadratic residue (the
decompressed point is then on the curve by construction; BN254 G1 has
cofactor 1, so on-curve implies the right subgroup), the infinity
encoding must be exact, scalars must be canonical (< r), reads past the
end of the proof raise, and the verifier checks the stream is exactly
consumed — otherwise invalid points would flow into the MSM/pairing
(invalid-point forgery) and encodings would be malleable.
"""
from __future__ import annotations

import hashlib

from .bn254 import AffinePoint, B_COEFF
from .bn254 import BN254_FQ as Q_MOD, BN254_FR as R_MOD

assert Q_MOD % 4 == 3  # sqrt(a) = a^((q+1)/4) below relies on this
_SQRT_EXP = (Q_MOD + 1) // 4

_FLAG_PARITY = 0x80  # top byte bit 7: y is odd
_FLAG_INF = 0x40  # top byte bit 6: point at infinity
_X_MASK = 0x3F


class ProofError(ValueError):
    """Malformed proof bytes (non-canonical or truncated encoding)."""


def _point_bytes(p: AffinePoint) -> bytes:
    if p.infinity:
        return b"\x00" * 31 + bytes([_FLAG_INF])
    b = bytearray(p.x.to_bytes(32, "little"))
    assert not b[31] & ~_X_MASK  # x < 2^254
    b[31] |= _FLAG_PARITY if (p.y & 1) else 0
    return bytes(b)


def _point_from_bytes(b: bytes) -> AffinePoint:
    flags = b[31] & ~_X_MASK
    xb = bytearray(b)
    xb[31] &= _X_MASK
    x = int.from_bytes(xb, "little")
    if flags & _FLAG_INF:
        if x != 0 or flags & _FLAG_PARITY:
            raise ProofError("non-canonical infinity encoding")
        return AffinePoint()
    if x >= Q_MOD:
        raise ProofError("non-canonical point coordinate")
    y2 = (x * x % Q_MOD * x + B_COEFF) % Q_MOD
    y = pow(y2, _SQRT_EXP, Q_MOD)
    if y * y % Q_MOD != y2:
        raise ProofError("x not on curve")
    if (y & 1) != bool(flags & _FLAG_PARITY):
        y = Q_MOD - y
    return AffinePoint(x, y)


def _scalar_bytes(s: int) -> bytes:
    return (s % R_MOD).to_bytes(32, "little")


class Transcript:
    """Write/read transcript with chained Blake2b squeezes."""

    def __init__(self, proof: bytes | None = None):
        self._h = hashlib.blake2b(b"zkfhe-tpu-v2")
        self._buf = bytearray()  # written proof bytes (prover mode)
        self._read = memoryview(proof) if proof is not None else None
        self._pos = 0

    # -- absorb-only (public inputs etc.) -----------------------------------
    def common_scalar(self, s: int):
        self._h.update(b"cs" + _scalar_bytes(s))

    def common_point(self, p: AffinePoint):
        self._h.update(b"cp" + _point_bytes(p))

    def common_bytes(self, data: bytes):
        """Absorb opaque context (e.g. the vk digest) with length framing."""
        self._h.update(b"cb" + len(data).to_bytes(8, "little") + data)

    # -- prover: write + absorb ---------------------------------------------
    def write_point(self, p: AffinePoint):
        b = _point_bytes(p)
        self._h.update(b"wp" + b)
        self._buf += b

    def write_scalar(self, s: int):
        b = _scalar_bytes(s)
        self._h.update(b"ws" + b)
        self._buf += b

    # -- verifier: read + absorb --------------------------------------------
    def _take(self, count: int) -> bytes:
        if self._read is None or self._pos + count > len(self._read):
            raise ProofError("proof truncated")
        b = bytes(self._read[self._pos:self._pos + count])
        self._pos += count
        return b

    def read_point(self) -> AffinePoint:
        b = self._take(32)
        self._h.update(b"wp" + b)
        return _point_from_bytes(b)

    def read_scalar(self) -> int:
        b = self._take(32)
        self._h.update(b"ws" + b)
        s = int.from_bytes(b, "little")
        if s >= R_MOD:
            raise ProofError("non-canonical scalar")
        return s

    def assert_consumed(self):
        """The proof must be exactly the bytes the protocol reads —
        trailing garbage would make encodings malleable."""
        if self._read is None or self._pos != len(self._read):
            raise ProofError("proof has trailing bytes")

    # -- challenges ---------------------------------------------------------
    def challenge(self) -> int:
        d = self._h.copy().digest()  # 64 bytes
        self._h.update(b"ch" + d)
        return int.from_bytes(d, "little") % R_MOD

    def proof_bytes(self) -> bytes:
        return bytes(self._buf)
