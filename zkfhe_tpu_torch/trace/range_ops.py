"""Range-check / comparison / div-mod ops over the trace IR (port of
zkfhe_tpu/trace/range_ops.py).

Semantics mirror halo2-base's RangeChip (used by the reference at
src/poly_chip.rs:7, :237-244, :293-315) but are re-implemented on the
vertical-gate + byte-lookup IR: values decompose into 8-bit limbs that live
in the lookup context (CTX_LK), where the logUp argument (backend) checks
membership in the byte table; limb recomposition is an accumulation chain
of vertical gates. All ops are vectorized over m cells at once.
"""
from __future__ import annotations

import torch

from ..ops import field as F
from .builder import (Builder, CellVec, CTX_LK, CTX_P1, LOOKUP_BITS,
                      _cbits)


def _lookup_cell(bld: Builder, values) -> CellVec:
    """Allocate cells in the lookup context holding `values` (L, m)."""
    idx = bld._alloc(CTX_LK, values, LOOKUP_BITS)
    return CellVec(CTX_LK, idx, values, LOOKUP_BITS)


def _byte_limb_values(bld: Builder, x: CellVec, k8: int):
    """Split x into k8 byte values, each as an (L, m) limb array."""
    out = []
    for j in range(k8):
        v = F.extract_bits(x.val, LOOKUP_BITS * j, LOOKUP_BITS)
        out.append(F.from_u32(v))
    return out


def range_check(bld: Builder, x: CellVec, bits: int):
    """Constrain 0 <= x < 2^bits. halo2-base `range_check` semantics:
    byte decomposition -> lookup; if bits % 8 != 0 the top limb is also
    checked shifted by (8 - bits%8) so its true width is bits%8."""
    assert bits > 0
    m = x.m
    k8 = -(-bits // LOOKUP_BITS)
    limb_vals = _byte_limb_values(bld, x, k8)
    limbs = [_lookup_cell(bld, v) for v in limb_vals]

    rem = bits % LOOKUP_BITS
    if rem:
        shift = 1 << (LOOKUP_BITS - rem)
        top = limbs[-1]
        shifted_val = bld.vmul(bld._const_arr(shift, m), top.val)
        shifted = _lookup_cell(bld, shifted_val)
        # region [0, top, shift, shifted]
        rctx, starts = bld._region(
            bld._zeros(m), top.val, bld._const_arr(shift, m), shifted_val,
            copies=[(1, top), (3, shifted)], consts=[(0, 0), (2, shift)],
            bits=(1, rem, _cbits(shift), LOOKUP_BITS),
        )

    xb = min(x.bits, bits)  # x's honest value after this check
    # recomposition chain: acc_j = acc_{j-1} + limb_j * 2^(8j); final == x
    if k8 == 1:
        bld._region(
            bld._zeros(m), limbs[0].val, bld._const_arr(1, m), x.val,
            copies=[(1, limbs[0]), (3, x)], consts=[(0, 0), (2, 1)],
            bits=(1, LOOKUP_BITS, 1, xb),
        )
        return limbs

    acc_val = limb_vals[0]
    acc = limbs[0]
    for j in range(1, k8):
        c = 1 << (LOOKUP_BITS * j)
        ab = LOOKUP_BITS * (j + 1)
        new_val = bld.vadd(acc_val, bld.vmul(bld._const_arr(c, m), limb_vals[j]))
        if j == k8 - 1:
            # last region: D slot is x itself (copy), closing the chain
            bld._region(
                acc_val, limbs[j].val, bld._const_arr(c, m), x.val,
                copies=[(0, acc), (1, limbs[j]), (3, x)], consts=[(2, c)],
                bits=(acc.bits, LOOKUP_BITS, _cbits(c), xb),
            )
        else:
            rctx, starts = bld._region(
                acc_val, limbs[j].val, bld._const_arr(c, m), new_val,
                copies=[(0, acc), (1, limbs[j])], consts=[(2, c)],
                bits=(acc.bits, LOOKUP_BITS, _cbits(c), ab),
            )
            acc = bld._cells_at(rctx, starts, 3, new_val, ab)
        acc_val = new_val
    return limbs


def check_less_than(bld: Builder, x: CellVec, bound: int, bits: int):
    """Constrain x < bound, assuming x < 2^bits is already enforced.
    shifted = x + (2^bits - bound) must fit in `bits` bits."""
    m = x.m
    pad = (1 << bits) - bound
    shifted_val = bld.vadd(x.val, bld._const_arr(pad, m))
    rctx, starts = bld._region(
        bld._const_arr(pad, m), x.val, bld._const_arr(1, m), shifted_val,
        copies=[(1, x)], consts=[(0, pad), (2, 1)],
        bits=(_cbits(pad), min(x.bits, bits), 1, bits),
    )
    shifted = bld._cells_at(rctx, starts, 3, shifted_val, bits)
    range_check(bld, shifted, bits)


def check_less_than_safe(bld: Builder, x: CellVec, bound: int):
    """Constrain 0 <= x < bound for a u64 bound (halo2-base
    check_less_than_safe, reference use: src/poly_chip.rs:293,364)."""
    bits = max(bound.bit_length(), 1)
    range_bits = -(-bits // LOOKUP_BITS) * LOOKUP_BITS
    range_check(bld, x, range_bits)
    check_less_than(bld, x, bound, range_bits)


def is_less_than(bld: Builder, x: CellVec, bound: int, bits: int) -> CellVec:
    """Witness bit out = (x < bound), sound given x < 2^bits
    (halo2-base is_less_than, reference use: src/poly_chip.rs:300,308).

    shifted = x - bound + 2^bits = low + ind * 2^bits with low < 2^bits,
    ind boolean; out = 1 - ind."""
    m = x.m
    pad = (1 << bits) - bound
    shifted_val = bld.vadd(x.val, bld._const_arr(pad, m))
    rctx, starts = bld._region(
        bld._const_arr(pad, m), x.val, bld._const_arr(1, m), shifted_val,
        copies=[(1, x)], consts=[(0, pad), (2, 1)],
        bits=(_cbits(pad), min(x.bits, bits), 1, bits + 1),
    )
    shifted = bld._cells_at(rctx, starts, 3, shifted_val, bits + 1)

    big = bld._const_arr(1 << bits, m)
    ind_lane = F.geq(shifted_val, big).to(torch.int32)
    ind_val = F.from_u32(ind_lane)
    low_val = torch.where(
        (ind_lane != 0).unsqueeze(0),
        F.sub_plain(shifted_val, big),
        shifted_val,
    )
    ind = bld.load_witness(ind_val, CTX_P1, bits=1)
    low = bld.load_witness(low_val, CTX_P1, bits=bits)
    bld.assert_bool(ind)
    range_check(bld, low, bits)
    # low + ind * 2^bits = shifted
    bld._region(
        low_val, ind_val, bld._const_arr(1 << bits, m), shifted_val,
        copies=[(0, low), (1, ind), (3, shifted)], consts=[(2, 1 << bits)],
        bits=(bits, 1, bits + 1, bits + 1),
    )
    return bld.not_(ind)


def div_mod(bld: Builder, x: CellVec, modulus: int, num_bits: int):
    """Witness (q, r) with x = q*modulus + r, r < modulus,
    q < 2^(num_bits - bits(modulus) + 1). Returns (q, r) cells.
    (halo2-base div_mod; reference use: src/poly_chip.rs:237-244.)

    Soundness: q*m + r < 2^(num_bits+1) + m << p, so the field equation
    implies the integer equation; bounds make (q, r) unique."""
    m = x.m
    q_bits = max(num_bits - modulus.bit_length() + 1, 1)
    q_val, r_val = F.divmod_const(x.val, modulus, num_bits)
    q = bld.load_witness(q_val, CTX_P1, bits=q_bits)
    r = bld.load_witness(r_val, CTX_P1, bits=modulus.bit_length())
    # r + q * modulus = x
    bld._region(
        r_val, q_val, bld._const_arr(modulus, m), x.val,
        copies=[(0, r), (1, q), (3, x)], consts=[(2, modulus)],
        bits=(modulus.bit_length(), q_bits, _cbits(modulus),
              min(x.bits, num_bits)),
    )
    range_check(bld, q, q_bits)
    check_less_than_safe(bld, r, modulus)
    return q, r
