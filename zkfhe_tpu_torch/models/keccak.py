"""In-circuit Keccak chip (port of zkfhe_tpu/models/keccak.py).

The reference's chip surface configures a KeccakChip for every circuit
(configs/bfv.json:17 records its ``keccak_rows_per_round``); the BFV
circuit itself leaves it unused. The design is the JAX package's:

  * the 1600-bit state is ONE vectorized CellVec of boolean cells
    (flat index = lane*64 + z, lane = x + 5y, bit z weight 2^z), so every
    keccak step is a handful of (L, 1600)-wide gate ops; on a CUDA device
    each is a few launches of the field kernels;
  * rho, pi and all lane rotations are static index permutations of the
    cell vector (numpy gathers of the handle and one index_select of the
    values): no gate and no witness work;
  * xor and chi are built from the single vertical gate A + B*C = D:
    xor(a,b) = s - 2t with s = a+b, t = a*b (3 regions/bit);
    chi's ~b & c = c - b*c (2 regions/bit) then one xor.

Ground truth: models/keccak_host.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import field as F
from ..trace.builder import CTX_P1, Builder, CellVec, concat_cells
from .keccak_host import RC, RHO, RATE_BYTES, pad_keccak256

STATE_BITS = 1600
RATE_BITS = RATE_BYTES * 8  # 1088


def _bits_to_vals(bits, device) -> torch.Tensor:
    """(m,) 0/1 -> (L, m) standard-form field values (limb 0 = bit) on
    `device`."""
    bits = torch.as_tensor(bits, device=device).to(F.DTYPE)
    out = F.zero(bits.shape, device)
    out[0] = bits
    return out


def _gather(cv: CellVec, perm: np.ndarray) -> CellVec:
    """Statically permute a cell vector (layout-only rewiring)."""
    perm = np.asarray(perm, dtype=np.int64)
    val = cv.val.index_select(1, torch.as_tensor(perm, device=cv.val.device))
    return CellVec(cv.ctx, cv.idx[perm], val, cv.bits)


# static permutation tables ------------------------------------------------

def _rho_pi_perm() -> np.ndarray:
    """dst[lane'*64 + z] = src bit for the fused rho+pi step:
    B[y + 5((2x+3y)%5)] = rot(A[x+5y], RHO[x+5y])."""
    perm = np.zeros(STATE_BITS, dtype=np.int64)
    for x in range(5):
        for y in range(5):
            src = x + 5 * y
            dst = y + 5 * ((2 * x + 3 * y) % 5)
            r = RHO[src]
            for z in range(64):
                perm[dst * 64 + z] = src * 64 + (z - r) % 64
    return perm


_RHO_PI = _rho_pi_perm()
_LANE = np.arange(STATE_BITS) // 64
_Z = np.arange(STATE_BITS) % 64
# theta: D replicated to all lanes; D is indexed by x = lane % 5
_D_TILE = (_LANE % 5) * 64 + _Z
# chi neighbours (x+1, y) and (x+2, y)
_CHI_B = ((_LANE % 5 + 1) % 5 + 5 * (_LANE // 5)) * 64 + _Z
_CHI_C = ((_LANE % 5 + 2) % 5 + 5 * (_LANE // 5)) * 64 + _Z
# theta parity: C[x] over 320 bits; D[x] = C[x-1] ^ rot1(C[x+1])
_X320 = np.arange(320) // 64
_Z320 = np.arange(320) % 64
_CM1 = ((_X320 - 1) % 5) * 64 + _Z320
_CP1R = ((_X320 + 1) % 5) * 64 + (_Z320 - 1) % 64


class KeccakChip:
    """Keccak-f[1600] + keccak256 sponge over vectorized boolean cells."""

    def __init__(self, bld: Builder):
        self.b = bld

    # -- boolean gate helpers (vectorized over the whole vector) -----------
    def xor(self, x: CellVec, y: CellVec) -> CellVec:
        """out = x ^ y = (x + y) - 2xy. Three vertical-gate regions per
        bit: t = x*y, s = x+y, then [out, t, 2, s] (out + 2t = s)."""
        b = self.b
        t = b.mul(x, y)
        s = b.add(x, y)
        m = x.m
        oval = b.vsub(s.val, b.vadd(t.val, t.val))
        rctx, st = b._region(
            oval, t.val, b._const_arr(2, m), s.val,
            copies=[(1, t), (3, s)], consts=[(2, 2)],
            bits=(1, 2, 2, 2),
        )
        return b._cells_at(rctx, st, 0, oval, 1)

    def not_and(self, x: CellVec, y: CellVec) -> CellVec:
        """out = (~x) & y = y - xy. Regions: t = x*y, then
        [out, t, 1, y] (out + t = y)."""
        b = self.b
        t = b.mul(x, y)
        m = x.m
        oval = b.vsub(y.val, t.val)
        rctx, st = b._region(
            oval, t.val, b._const_arr(1, m), y.val,
            copies=[(1, t), (3, y)], consts=[(2, 1)],
            bits=(1, 2, 1, 1),
        )
        return b._cells_at(rctx, st, 0, oval, 1)

    # -- state I/O ----------------------------------------------------------
    def load_bits(self, bits, assert_boolean: bool = True) -> CellVec:
        """Load a 0/1 vector as witness bit cells (+ booleanity gates)."""
        cv = self.b.load_witness(_bits_to_vals(bits, self.b.device), CTX_P1,
                                 bits=1)
        if assert_boolean:
            self.b.assert_bool(cv)
        return cv

    def const_bits(self, bits: np.ndarray) -> CellVec:
        return self.b.load_constants([int(v) for v in bits], CTX_P1)

    # -- the permutation ------------------------------------------------------
    def keccak_round(self, state: CellVec, rc: int) -> CellVec:
        # theta: C[x] = xor over the 5 rows (y-slices are contiguous)
        Cp = state.slice(0, 320)
        for y in range(1, 5):
            Cp = self.xor(Cp, state.slice(320 * y, 320 * (y + 1)))
        D = self.xor(_gather(Cp, _CM1), _gather(Cp, _CP1R))
        state = self.xor(state, _gather(D, _D_TILE))
        # rho + pi: static rewiring
        state = _gather(state, _RHO_PI)
        # chi: a ^ ((~b) & c)
        state = self.xor(
            state,
            self.not_and(_gather(state, _CHI_B), _gather(state, _CHI_C)),
        )
        # iota: flip the bits of lane 0 where rc has a 1 (out = 1 - bit)
        setpos = np.asarray([z for z in range(64) if (rc >> z) & 1],
                            dtype=np.int64)
        flipped = self.b.not_(_gather(state, setpos))
        keep = np.setdiff1d(np.arange(STATE_BITS, dtype=np.int64), setpos)
        cells = concat_cells([flipped, _gather(state, keep)])
        return _gather(cells, np.argsort(np.concatenate([setpos, keep])))

    def keccak_f(self, state: CellVec) -> CellVec:
        assert state.m == STATE_BITS
        for rc in RC:
            state = self.keccak_round(state, rc)
        return state

    # -- the sponge -----------------------------------------------------------
    def keccak256(self, msg_bits: CellVec | None, msg_len: int):
        """keccak256 of a `msg_len`-byte message whose bits (LSB-first
        per byte, 8*msg_len cells) are `msg_bits` (None for the empty
        message). Padding bits are in-circuit constants. Returns
        (digest_bits (256,), words (8,)) where words are the digest
        packed into eight 32-bit little-endian limbs (each word cell is a
        narrow 32-bit value).
        """
        assert msg_bits is None or msg_bits.m == 8 * msg_len
        pad = pad_keccak256(b"\x00" * msg_len)[msg_len:]
        pad_bits = np.asarray(
            [(byte >> j) & 1 for byte in pad for j in range(8)])
        stream = []  # per-block bit cell vectors (rate-sized)
        total = 8 * msg_len + len(pad_bits)
        assert total % RATE_BITS == 0
        pad_cells = self.const_bits(pad_bits)
        for blk in range(total // RATE_BITS):
            lo, hi = blk * RATE_BITS, (blk + 1) * RATE_BITS
            parts = []
            if lo < 8 * msg_len:
                parts.append(msg_bits.slice(lo, min(hi, 8 * msg_len)))
            if hi > 8 * msg_len:
                parts.append(pad_cells.slice(
                    max(lo - 8 * msg_len, 0), hi - 8 * msg_len))
            stream.append(concat_cells(parts))

        cap0 = self.const_bits(np.zeros(STATE_BITS - RATE_BITS, dtype=int))
        state = concat_cells([stream[0], cap0])  # initial state is zero
        state = self.keccak_f(state)
        for block in stream[1:]:
            state = concat_cells([
                self.xor(state.slice(0, RATE_BITS), block),
                state.slice(RATE_BITS, STATE_BITS),
            ])
            state = self.keccak_f(state)

        digest = state.slice(0, 256)
        pw = self.b.load_constants([1 << i for i in range(32)], CTX_P1)
        words = concat_cells([
            self.b.inner_product(digest.slice(32 * w, 32 * (w + 1)), pw)
            for w in range(8)
        ])
        return digest, words


def message_bits(msg: bytes) -> np.ndarray:
    """The sponge's bit order of a message: LSB first within each byte."""
    return np.asarray([(byte >> j) & 1 for byte in msg for j in range(8)],
                      dtype=np.int64)


def keccak256_circuit(msg_len: int):
    """Circuit function: keccak256 of the ``msg_len``-byte message whose
    bits (``message_bits``) are ``inputs["bits"]``, with the digest's eight
    32-bit words exposed as public values. ``inputs["bits"]`` is also
    what places the circuit on a device, so it is given (empty) for the
    empty message."""
    def circuit(bld: Builder, inputs):
        chip = KeccakChip(bld)
        bits = chip.load_bits(inputs["bits"]) if msg_len else None
        _, words = chip.keccak256(bits, msg_len)
        bld.expose_public(words)
    return circuit
