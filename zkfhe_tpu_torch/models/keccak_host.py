"""Host-side Keccak reference model (copy of
zkfhe_tpu/models/keccak_host.py): the exact-integer ground truth that the
KeccakChip (models/keccak.py) is tested against. Pure python ints.

Conventions (little-endian throughout, FIPS-202 / original Keccak):
  * state lane (x, y) lives at index ``x + 5*y`` in a 25-list;
  * bit z of a lane has weight 2^z;
  * byte i of the sponge maps to lane i//8, bits 8*(i%8)..8*(i%8)+7;
  * keccak256 = rate 1088 / capacity 512, pad10*1 with domain bit 0x01
    (the pre-NIST Ethereum variant, NOT sha3-256's 0x06).
"""
from __future__ import annotations

MASK64 = (1 << 64) - 1

# round constants for keccak-f[1600] (24 rounds)
RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets, indexed [x + 5*y]
RHO = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def rot64(v: int, r: int) -> int:
    r %= 64
    return ((v << r) | (v >> (64 - r))) & MASK64


def keccak_round(A: list, rc: int) -> list:
    """One round of keccak-f[1600] on a 25-lane state."""
    # theta
    C = [A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20]
         for x in range(5)]
    D = [C[(x - 1) % 5] ^ rot64(C[(x + 1) % 5], 1) for x in range(5)]
    A = [A[i] ^ D[i % 5] for i in range(25)]
    # rho + pi: B[y + 5*((2x+3y)%5)] = rot(A[x + 5y], RHO[x + 5y])
    B = [0] * 25
    for x in range(5):
        for y in range(5):
            B[y + 5 * ((2 * x + 3 * y) % 5)] = rot64(A[x + 5 * y],
                                                     RHO[x + 5 * y])
    # chi: A[x,y] = B[x,y] ^ (~B[x+1,y] & B[x+2,y])
    A = [
        B[i] ^ ((B[(i % 5 + 1) % 5 + 5 * (i // 5)] ^ MASK64)
                & B[(i % 5 + 2) % 5 + 5 * (i // 5)])
        for i in range(25)
    ]
    # iota
    A[0] ^= rc
    return A


def keccak_f(lanes: list) -> list:
    A = list(lanes)
    for rc in RC:
        A = keccak_round(A, rc)
    return A


RATE_BYTES = 136  # 1088-bit rate for keccak256


def pad_keccak256(data: bytes) -> bytes:
    """pad10*1 with the 0x01 domain bit (Ethereum keccak256)."""
    q = RATE_BYTES - len(data) % RATE_BYTES
    if q == 1:
        return data + b"\x81"
    return data + b"\x01" + b"\x00" * (q - 2) + b"\x80"


def keccak256(data: bytes) -> bytes:
    padded = pad_keccak256(data)
    state = [0] * 25
    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off:off + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        state = keccak_f(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out


def bits_of_lanes(lanes: list) -> list:
    """25 lanes -> 1600 bit list, flat index = lane*64 + z."""
    return [(lanes[i] >> z) & 1 for i in range(25) for z in range(64)]


def lanes_of_bits(bits: list) -> list:
    assert len(bits) == 1600
    return [
        sum(bits[i * 64 + z] << z for z in range(64)) for i in range(25)
    ]
