"""AritPIM-style bit-serial element-parallel arithmetic (paper §3, refs [3,4]).

Every algorithm is written once against the :class:`~repro_torch.core.machine.PlaneVM`
gate DSL and therefore yields simultaneously

* a bit-exact simulation (execute mode, packed int32 planes),
* an exact NOR-gate count (the paper's compute-complexity unit), and
* a recordable flat NOR schedule for the CUDA executors.

Conventions: all plane lists are LSB-first.  float32 layout (LSB-first):
planes[0:23] mantissa, planes[23:31] exponent, planes[31] sign.

Fixed-point addition is the paper's reference point: a 9-NOR full adder
rippled N times → 9N gates (paper §3).  Multiplication is schoolbook
shift-and-add ≈ 10N² gates (paper §3: "approximately 10N²").  Floating point
follows IEEE 754 binary32 with round-to-nearest-even, gradual underflow
(subnormals), signed zeros and Inf/NaN propagation — the properties FloatPIM
got wrong and AritPIM fixed (paper §1, §3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from .machine import PlaneVM

Plane = Any  # int32 tensor (execute) or int col id (record)


# --------------------------------------------------------------------------
# Ripple-carry building blocks
# --------------------------------------------------------------------------

def ripple_add(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane], cin: Plane | None = None):
    """N-bit ripple-carry add → (sum planes, carry-out).  9 gates/bit."""
    assert len(A) == len(B)
    c = cin if cin is not None else vm.const0()
    out = []
    for a, b in zip(A, B):
        s, c = vm.full_adder(a, b, c)
        out.append(s)
    return out, c


def ripple_sub(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """A - B (two's complement).  Returns (diff, no_borrow); no_borrow=1 ⟺ A ≥ B
    for unsigned interpretation."""
    nB = [vm.not_(b) for b in B]
    return ripple_add(vm, A, nB, cin=vm.const1())


def ripple_inc(vm: PlaneVM, A: Sequence[Plane], cin: Plane):
    """A + cin (single-bit increment chain): 8 gates/bit."""
    out = []
    c = cin
    for a in A:
        s = vm.xor(a, c)
        c = vm.and_(a, c)
        out.append(s)
    return out, c


def ripple_dec(vm: PlaneVM, A: Sequence[Plane], bin_: Plane):
    """A - bin_ (single-bit borrow chain)."""
    out = []
    b = bin_
    for a in A:
        s = vm.xor(a, b)
        b = vm.and_(vm.not_(a), b)
        out.append(s)
    return out, b


def const_planes(vm: PlaneVM, value: int, nbits: int) -> list[Plane]:
    return [vm.const1() if (value >> j) & 1 else vm.const0() for j in range(nbits)]


def mux_planes(vm: PlaneVM, s: Plane, X: Sequence[Plane], Y: Sequence[Plane]) -> list[Plane]:
    """Elementwise s ? X : Y."""
    assert len(X) == len(Y)
    return [vm.mux(s, x, y) for x, y in zip(X, Y)]


def zero_planes(vm: PlaneVM, n: int) -> list[Plane]:
    z = vm.const0()
    return [z] * n


def and_tree(vm: PlaneVM, xs: Sequence[Plane]) -> Plane:
    return vm.not_(vm.or_tree([vm.not_(x) for x in xs]))


def unsigned_lt(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]) -> Plane:
    """1 ⟺ A < B (unsigned)."""
    _, no_borrow = ripple_sub(vm, list(A), list(B))
    return vm.not_(no_borrow)


def extend(vm: PlaneVM, A: Sequence[Plane], n: int) -> list[Plane]:
    A = list(A)
    while len(A) < n:
        A.append(vm.const0())
    return A


# --------------------------------------------------------------------------
# Variable shifters (log-shifter with MUX stages) and leading-zero count
# --------------------------------------------------------------------------

def shift_right_var(vm: PlaneVM, R: Sequence[Plane], d: Sequence[Plane], sticky: Plane):
    """Logical right shift of register R (LSB-first) by value d, OR-ing
    shifted-out bits into ``sticky``.  Returns (R', sticky')."""
    R = list(R)
    n = len(R)
    for k, dk in enumerate(d):
        amt = 1 << k
        lost = vm.or_tree(R[: min(amt, n)])
        sticky = vm.or_(sticky, vm.and_(dk, lost))
        shifted = [R[i + amt] if i + amt < n else vm.const0() for i in range(n)]
        R = mux_planes(vm, dk, shifted, R)
    return R, sticky


def shift_left_var(vm: PlaneVM, R: Sequence[Plane], d: Sequence[Plane]):
    """Logical left shift (zero fill).  Overflowing bits are dropped (caller
    guarantees they are zero)."""
    R = list(R)
    n = len(R)
    for k, dk in enumerate(d):
        amt = 1 << k
        shifted = [R[i - amt] if i - amt >= 0 else vm.const0() for i in range(n)]
        R = mux_planes(vm, dk, shifted, R)
    return R


def leading_zero_count(vm: PlaneVM, R: Sequence[Plane]):
    """LZC of register R (LSB-first, MSB = R[-1]).  Returns (lzc planes, all_zero).
    For all-zero input lzc reads n-1 from the encoder; use the flag."""
    R = list(R)
    n = len(R)
    pref = [None] * n  # pref[i] = OR(R[n-1] .. R[i])
    pref[n - 1] = R[n - 1]
    for i in range(n - 2, -1, -1):
        pref[i] = vm.or_(pref[i + 1], R[i])
    all_zero = vm.not_(pref[0])
    h = [None] * n  # one-hot leading-one position
    h[n - 1] = R[n - 1]
    for i in range(n - 1):
        h[i] = vm.and_(R[i], vm.not_(pref[i + 1]))
    nbits = max(1, (n - 1).bit_length())
    lzc = []
    for k in range(nbits):
        terms = [h[i] for i in range(n) if ((n - 1 - i) >> k) & 1]
        lzc.append(vm.or_tree(terms) if terms else vm.const0())
    return lzc, all_zero


# --------------------------------------------------------------------------
# Fixed point (paper §3)
# --------------------------------------------------------------------------

def fixed_add(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """N-bit two's complement add (wrapping), 9N gates — the paper's headline."""
    s, _ = ripple_add(vm, A, B)
    return s


def fixed_sub(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    s, _ = ripple_sub(vm, A, B)
    return s


def negate(vm: PlaneVM, A: Sequence[Plane]):
    nA = [vm.not_(a) for a in A]
    s, _ = ripple_inc(vm, nA, vm.const1())
    return s


def fixed_mul_unsigned(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """Unsigned schoolbook multiply: N×M → N+M bits, ≈10·N·M gates (paper §3)."""
    n, m = len(A), len(B)
    nA = [vm.not_(a) for a in A]
    nB = [vm.not_(b) for b in B]
    acc = zero_planes(vm, n + m)
    carry_into_top = None
    for j in range(m):
        pp = [vm.nor(nA[i], nB[j]) for i in range(n)]  # a_i AND b_j
        seg, cout = ripple_add(vm, acc[j : j + n], pp)
        acc[j : j + n] = seg
        if j + n < n + m:
            # carry ripples into a zero column: plain copy
            acc[j + n] = cout
    del carry_into_top
    return acc


def fixed_mul_signed(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """Signed N×N → 2N via sign-magnitude around the unsigned core.
    |INT_MIN| is representable unsigned, so conditional negation is exact."""
    n = len(A)
    sa, sb = A[-1], B[-1]
    absA = mux_planes(vm, sa, negate(vm, A), list(A))
    absB = mux_planes(vm, sb, negate(vm, B), list(B))
    P = fixed_mul_unsigned(vm, absA, absB)
    sp = vm.xor(sa, sb)
    return mux_planes(vm, sp, negate(vm, P), P)


def fixed_div_unsigned(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """Unsigned restoring division: N-bit quotient + remainder, ≈16N² gates.
    Division by zero yields Q = all-ones, R = A (documented convention)."""
    n = len(A)
    R = zero_planes(vm, n + 1)  # one headroom bit for the shifted compare
    Bx = extend(vm, list(B), n + 1)
    Q: list[Plane] = [None] * n  # type: ignore[list-item]
    for i in range(n - 1, -1, -1):
        R = [A[i]] + R[:-1]  # R = (R << 1) | a_i
        diff, no_borrow = ripple_sub(vm, R, Bx)
        Q[i] = no_borrow  # 1 ⟺ R >= B
        R = mux_planes(vm, no_borrow, diff, R)
    return Q, R[:n]


def fixed_div_signed(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """Signed division (C semantics: truncation toward zero)."""
    sa, sb = A[-1], B[-1]
    absA = mux_planes(vm, sa, negate(vm, A), list(A))
    absB = mux_planes(vm, sb, negate(vm, B), list(B))
    Q, R = fixed_div_unsigned(vm, absA, absB)
    sq = vm.xor(sa, sb)
    Q = mux_planes(vm, sq, negate(vm, Q), Q)
    R = mux_planes(vm, sa, negate(vm, R), R)  # remainder takes dividend sign
    return Q, R


def float_div(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """IEEE-754 binary32 division, RNE, subnormals, Inf/NaN/zero cases.

    Mantissa path: pre-normalize subnormal inputs (LZC), 26-bit long division
    of the significands with a sticky remainder, 1-step normalize, gradual
    underflow, round-to-nearest-even."""
    a = _unpack_f32(vm, A)
    b = _unpack_f32(vm, B)
    s = vm.xor(a["s"], b["s"])

    # --- pre-normalize significands (subnormal inputs have leading zeros)
    def prenorm(M, e_eff):
        lz, _ = leading_zero_count(vm, M)  # 5-bit (n=24)
        Mn = shift_left_var(vm, M, lz)
        e11 = extend(vm, list(e_eff), 11)
        e_adj, _ = ripple_sub(vm, e11, extend(vm, lz, 11))
        return Mn, e_adj

    Ma, ea = prenorm(a["M"], a["e_eff"])
    Mb, eb = prenorm(b["M"], b["e_eff"])

    # --- exponent: e = ea - eb + 127  (11-bit two's complement)
    E, _ = ripple_sub(vm, ea, eb)
    E, _ = ripple_add(vm, E, const_planes(vm, 127, 11))

    # --- quotient of normalized significands: restoring long division of
    # X = Ma·2^26 by Mb (50 feed steps: 24 integer bits MSB-first, then 26
    # fractional zeros).  Quotient = floor(Ma·2^26/Mb) ∈ (2^25, 2^27).
    R = zero_planes(vm, 25)
    Bx = extend(vm, Mb, 25)
    feed_bits = list(reversed(list(Ma)))  # MSB first
    q_msb_first: list[Plane] = []
    for step in range(24 + 26):
        feed = feed_bits[step] if step < 24 else vm.const0()
        R = [feed] + R[:-1]
        diff, no_borrow = ripple_sub(vm, R, Bx)
        q_msb_first.append(no_borrow)
        R = mux_planes(vm, no_borrow, diff, R)
    sticky = vm.or_tree(R)  # non-zero remainder
    Q = list(reversed(q_msb_first))[:27]  # LSB-first, 27 significant bits

    # Q in (2^25, 2^27): leading one at 26 (quotient ≥ 1) or 25 (< 1)
    lead1 = Q[26]
    # if quotient < 1: shift LEFT 1 (LSB-first: prepend zero), e -= 1
    Qn = mux_planes(vm, lead1, Q, [vm.const0()] + Q[:-1])
    E, _ = ripple_dec(vm, E, vm.not_(lead1))

    # --- gradual underflow: if E <= 0 shift right by (1 - E) with sticky
    one11 = const_planes(vm, 1, 11)
    t, _ = ripple_sub(vm, one11, E)
    e_le0 = vm.not_(t[10])
    E_is1 = vm.not_(vm.or_tree([vm.xor(x, y) for x, y in zip(E, one11)]))
    need_den = vm.and_(e_le0, vm.not_(E_is1))
    t_clamped = mux_planes(vm, need_den, t, zero_planes(vm, 11))
    big_t = vm.or_tree(t_clamped[6:])
    lost = vm.or_tree(Qn)
    Qn, sticky = shift_right_var(vm, Qn, t_clamped[:6], sticky)
    sticky = vm.or_(sticky, vm.and_(big_t, lost))
    Qn = mux_planes(vm, big_t, zero_planes(vm, 27), Qn)
    E = mux_planes(vm, need_den, one11, E)

    # --- round to nearest even: significand = bits [3..26] (hidden at 26),
    # G = bit 2, R = bit 1, S = bit 0 ∨ remainder-sticky
    g, r = Qn[2], Qn[1]
    st = vm.or_(sticky, Qn[0])
    lsb = Qn[3]
    inc = vm.and_(g, vm.or_tree([r, st, lsb]))
    Mr, cr = ripple_inc(vm, Qn[3:27], inc)  # 24 bits incl hidden
    E, _ = ripple_inc(vm, E, cr)
    hidden_out = vm.or_(Mr[23], cr)
    m_out = mux_planes(vm, cr, zero_planes(vm, 23), Mr[0:23])
    e_enc = [vm.and_(hidden_out, x) for x in E[:8]]

    ge255 = vm.or_(vm.or_(E[8], vm.or_(E[9], E[10])), and_tree(vm, E[:8]))
    # E sign only possible pre-denorm; after mux E >= 1
    normal = _pack_f32(vm, s, e_enc, m_out)

    # --- specials
    res_nan = vm.or_tree([
        a["nan"], b["nan"],
        vm.and_(a["zero"], b["zero"]),  # 0/0
        vm.and_(a["inf"], b["inf"]),    # inf/inf
    ])
    res_inf = vm.and_(vm.or_(a["inf"], b["zero"]), vm.not_(res_nan))
    res_zero = vm.and_(vm.or_(a["zero"], b["inf"]), vm.not_(res_nan))

    zero_planes32 = [vm.const0()] * 23 + [vm.const0()] * 8 + [s]
    out = mux_planes(vm, ge255, _inf_planes(vm, s), normal)
    out = mux_planes(vm, res_zero, zero_planes32, out)
    out = mux_planes(vm, res_inf, _inf_planes(vm, s), out)
    out = mux_planes(vm, res_nan, _qnan_planes(vm), out)
    return out


# --------------------------------------------------------------------------
# IEEE-754 binary floating point, format-parameterized (paper §3, AritPIM [3])
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """IEEE-754-style binary format: LSB-first layout [mantissa | exp | sign]."""

    e_bits: int
    m_bits: int

    @property
    def width(self) -> int:
        return 1 + self.e_bits + self.m_bits

    @property
    def bias(self) -> int:
        return (1 << (self.e_bits - 1)) - 1


FLOAT32 = FloatFormat(e_bits=8, m_bits=23)
BFLOAT16 = FloatFormat(e_bits=8, m_bits=7)


def _unpack_float(vm: PlaneVM, X: Sequence[Plane], fmt: FloatFormat):
    mb, eb = fmt.m_bits, fmt.e_bits
    m = list(X[0:mb])
    e = list(X[mb:mb + eb])
    s = X[mb + eb]
    hidden = vm.or_tree(e)  # e != 0
    exp_all1 = and_tree(vm, e)
    m_nonzero = vm.or_tree(m)
    is_nan = vm.and_(exp_all1, m_nonzero)
    is_inf = vm.and_(exp_all1, vm.not_(m_nonzero))
    is_zero = vm.and_(vm.not_(hidden), vm.not_(m_nonzero))
    # effective exponent: subnormals live at scale e=1
    e_eff = [vm.or_(e[0], vm.not_(hidden))] + e[1:]
    M = m + [hidden]  # (m_bits+1)-bit significand with hidden bit
    return dict(s=s, e=e, m=m, e_eff=e_eff, M=M, hidden=hidden,
                nan=is_nan, inf=is_inf, zero=is_zero)


def _qnan_planes(vm: PlaneVM, fmt: FloatFormat = FLOAT32):
    one, zero = vm.const1(), vm.const0()
    m = [zero] * (fmt.m_bits - 1) + [one]  # quiet bit
    e = [one] * fmt.e_bits
    return m + e + [zero]


def _inf_planes(vm: PlaneVM, sign: Plane, fmt: FloatFormat = FLOAT32):
    one, zero = vm.const1(), vm.const0()
    return [zero] * fmt.m_bits + [one] * fmt.e_bits + [sign]


def _pack_float(vm: PlaneVM, s: Plane, e: Sequence[Plane], m: Sequence[Plane],
                fmt: FloatFormat):
    assert len(e) == fmt.e_bits and len(m) == fmt.m_bits
    return list(m) + list(e) + [s]


def _unpack_f32(vm: PlaneVM, X: Sequence[Plane]):
    return _unpack_float(vm, X, FLOAT32)


def _pack_f32(vm: PlaneVM, s: Plane, e: Sequence[Plane], m: Sequence[Plane]):
    return _pack_float(vm, s, e, m, FLOAT32)


def float_add_fmt(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane],
                  fmt: FloatFormat = FLOAT32):
    """IEEE-754 addition for any (e_bits, m_bits) format: RNE, subnormals,
    ±0, Inf/NaN.  float32 and bfloat16 are instantiations of this netlist."""
    mb, eb = fmt.m_bits, fmt.e_bits
    reg = mb + 4  # [s, r, g | M] with the hidden bit on top
    a = _unpack_float(vm, A, fmt)
    b = _unpack_float(vm, B, fmt)
    eff_sub = vm.xor(a["s"], b["s"])

    # --- magnitude compare on (e, m) as a (width-1)-bit integer, swap to L >= S
    magA = list(A[0:mb + eb])
    magB = list(B[0:mb + eb])
    lt = unsigned_lt(vm, magA, magB)  # |A| < |B|
    e_l = mux_planes(vm, lt, b["e_eff"], a["e_eff"])
    e_s = mux_planes(vm, lt, a["e_eff"], b["e_eff"])
    M_l = mux_planes(vm, lt, b["M"], a["M"])
    M_s = mux_planes(vm, lt, a["M"], b["M"])
    s_l = vm.mux(lt, b["s"], a["s"])

    # --- align smaller significand: registers are reg bits = [s, r, g | M<<3]
    d, _ = ripple_sub(vm, e_l, e_s)  # e_l >= e_s by the swap
    Sreg = zero_planes(vm, 3) + M_s
    sticky = vm.const0()
    # low shift stages cover 0..2^klow-1 >= reg-1; higher d bits empty the reg
    klow = max(1, (reg - 1).bit_length())
    Sreg, sticky = shift_right_var(vm, Sreg, d[:klow], sticky)
    if klow < eb:
        top_big = vm.or_tree(d[klow:])  # d >= 2^klow: all out
        lost_all = vm.or_tree(Sreg)
        sticky = vm.or_(sticky, vm.and_(top_big, lost_all))
        Sreg = mux_planes(vm, top_big, zero_planes(vm, reg), Sreg)

    # --- add/sub
    Lreg = zero_planes(vm, 3) + M_l
    Bx = [vm.xor(x, eff_sub) for x in Sreg]
    R, cout = ripple_add(vm, Lreg, Bx, cin=eff_sub)
    top = vm.and_(vm.not_(eff_sub), cout)  # bit reg (add overflow)
    V = R + [top]  # reg+1 bits
    # Effective subtraction with shifted-out bits: the true result lies in
    # (V-1, V) at bottom-bit scale — the sticky acts as a *borrow* here
    # (classic FP-adder correction; without it results are 1 ULP high).
    borrow = vm.and_(eff_sub, sticky)
    V, _ = ripple_dec(vm, V, borrow)

    # --- normalize: conditional right-1 (top set), then clamped left shift
    cond = top
    W = [vm.mux(cond, V[i + 1], V[i]) for i in range(reg)]
    sticky = vm.or_(sticky, vm.and_(cond, V[0]))
    e_base, _ = ripple_inc(vm, e_l + [vm.const0()], cond)  # eb+1 bits
    lz, all_zero = leading_zero_count(vm, W)
    lzx = extend(vm, lz, eb + 1)
    e_m1, _ = ripple_sub(vm, e_base, const_planes(vm, 1, eb + 1))
    lz_small = unsigned_lt(vm, lzx, e_m1)
    # shiftL = min(lz, e_base - 1)   (e_base >= 1 always)
    shiftL = mux_planes(vm, lz_small, lzx, e_m1)
    W = shift_left_var(vm, W, shiftL[:len(lz)])
    e_new, _ = ripple_sub(vm, e_base, shiftL)

    # --- round to nearest even
    g, r = W[2], W[1]
    st = vm.or_(W[0], sticky)
    lsb = W[3]
    inc = vm.and_(g, vm.or_tree([r, st, lsb]))
    Mr, cr = ripple_inc(vm, W[3:3 + mb + 1], inc)
    e_fin, _ = ripple_inc(vm, e_new, cr)  # eb+1 bits
    hidden_out = vm.or_(Mr[mb], cr)
    m_out = mux_planes(vm, cr, zero_planes(vm, mb), Mr[0:mb])
    e_enc = [vm.and_(hidden_out, x) for x in e_fin[:eb]]

    # --- overflow to inf: e_fin >= 2^eb - 1
    ge_max = vm.or_(e_fin[eb], and_tree(vm, e_fin[:eb]))

    # --- zero result (exact cancellation): sign = s_a AND s_b (RNE)
    zero_res = all_zero
    sign_zero = vm.and_(a["s"], b["s"])
    s_res = vm.mux(zero_res, sign_zero, s_l)
    e_enc = mux_planes(vm, zero_res, zero_planes(vm, eb), e_enc)
    m_out = mux_planes(vm, zero_res, zero_planes(vm, mb), m_out)

    normal = _pack_float(vm, s_res, e_enc, m_out, fmt)

    # --- special chain: overflow → Inf, input Inf, NaN
    res_nan = vm.or_tree([a["nan"], b["nan"], vm.and_(vm.and_(a["inf"], b["inf"]), eff_sub)])
    res_inf = vm.and_(vm.or_(a["inf"], b["inf"]), vm.not_(res_nan))
    inf_sign = vm.mux(a["inf"], a["s"], b["s"])

    out = mux_planes(vm, ge_max, _inf_planes(vm, s_l, fmt), normal)
    out = mux_planes(vm, res_inf, _inf_planes(vm, inf_sign, fmt), out)
    out = mux_planes(vm, res_nan, _qnan_planes(vm, fmt), out)
    return out


def float_add(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """IEEE-754 binary32 addition, RNE, subnormals, ±0, Inf/NaN."""
    return float_add_fmt(vm, A, B, FLOAT32)


def float_sub(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    Bneg = list(B[:31]) + [vm.not_(B[31])]
    return float_add(vm, A, Bneg)


def bf16_add(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """bfloat16 addition (same netlist as float32, narrower mantissa)."""
    return float_add_fmt(vm, A, B, BFLOAT16)


def bf16_sub(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """bfloat16 subtraction: addition with B's sign plane inverted."""
    Bneg = list(B[:15]) + [vm.not_(B[15])]
    return float_add_fmt(vm, A, Bneg, BFLOAT16)


def float_mul_fmt(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane],
                  fmt: FloatFormat = FLOAT32):
    """IEEE-754 multiplication for any format: RNE, gradual underflow, Inf/NaN."""
    mb, eb = fmt.m_bits, fmt.e_bits
    pw = 2 * (mb + 1)  # significand product width
    extw = eb + 3  # two's-complement exponent working width
    a = _unpack_float(vm, A, fmt)
    b = _unpack_float(vm, B, fmt)
    s = vm.xor(a["s"], b["s"])

    # --- significand product: (mb+1)×(mb+1) → pw bits (the dominant ~10N² gates)
    P = fixed_mul_unsigned(vm, a["M"], b["M"])

    # --- exponent: E = e_a_eff + e_b_eff - bias, as extw-bit two's complement
    e_sum, c = ripple_add(vm, extend(vm, a["e_eff"], eb + 1), extend(vm, b["e_eff"], eb + 1))
    E = e_sum + [c, vm.const0()]  # extw bits, always >= 0 here
    E, _ = ripple_sub(vm, E, const_planes(vm, fmt.bias, extw))

    # --- normalize: leading one target position pw-2
    cond_top = P[pw - 1]
    W = [vm.mux(cond_top, P[i + 1], P[i]) for i in range(pw - 1)]
    sticky = vm.and_(cond_top, P[0])
    E, _ = ripple_inc(vm, E, cond_top)

    lz, p_zero = leading_zero_count(vm, W)
    lzx = extend(vm, lz, extw)
    e_m1, _ = ripple_sub(vm, E, const_planes(vm, 1, extw))
    e_m1_neg = e_m1[extw - 1]
    lz_small = unsigned_lt(vm, lzx, e_m1)  # valid when e_m1 >= 0
    shiftL = mux_planes(vm, lz_small, lzx, e_m1)
    shiftL = mux_planes(vm, e_m1_neg, zero_planes(vm, extw), shiftL)
    W = shift_left_var(vm, W, shiftL[:len(lz)])
    E, _ = ripple_sub(vm, E, shiftL)

    # --- gradual underflow: if E <= 0 shift right by (1 - E), E := 1
    one_x = const_planes(vm, 1, extw)
    t, _ = ripple_sub(vm, one_x, E)  # 1 - E
    e_le0 = vm.not_(t[extw - 1])  # t >= 0 ⟺ E <= 1; combine with E != 1
    E_is1 = vm.not_(vm.or_tree([vm.xor(x, y) for x, y in zip(E, one_x)]))
    need_den = vm.and_(e_le0, vm.not_(E_is1))
    t_clamped = mux_planes(vm, need_den, t, zero_planes(vm, extw))
    kshift = max(1, (pw - 2).bit_length())  # stages covering 0..2^kshift-1 >= pw-2
    big_t = vm.or_tree(t_clamped[kshift:])  # t >= 2^kshift: all bits out
    lost = vm.or_tree(W)
    W, sticky = shift_right_var(vm, W, t_clamped[:kshift], sticky)
    sticky = vm.or_(sticky, vm.and_(big_t, lost))
    W = mux_planes(vm, big_t, zero_planes(vm, pw - 1), W)
    E = mux_planes(vm, need_den, one_x, E)

    # --- round to nearest even: mantissa = W[mb..pw-2], G/R below, S = rest
    g, r = W[mb - 1], W[mb - 2]
    st = vm.or_(vm.or_tree(W[0:mb - 2]) if mb > 2 else vm.const0(), sticky)
    lsb = W[mb]
    inc = vm.and_(g, vm.or_tree([r, st, lsb]))
    Mr, cr = ripple_inc(vm, W[mb:pw - 1], inc)
    E, _ = ripple_inc(vm, E, cr)
    hidden_out = vm.or_(Mr[mb], cr)
    m_out = mux_planes(vm, cr, zero_planes(vm, mb), Mr[0:mb])
    e_enc = [vm.and_(hidden_out, x) for x in E[:eb]]

    # overflow: E >= 2^eb - 1 (E >= 0 by now)
    ge_max = vm.or_(vm.or_tree(list(E[eb:extw])), and_tree(vm, E[:eb]))

    # exact zero significand product (either input zero)
    zero_sig = vm.and_(p_zero, vm.not_(cond_top))
    e_enc = mux_planes(vm, zero_sig, zero_planes(vm, eb), e_enc)
    m_out = mux_planes(vm, zero_sig, zero_planes(vm, mb), m_out)

    normal = _pack_float(vm, s, e_enc, m_out, fmt)

    res_nan = vm.or_tree([
        a["nan"], b["nan"],
        vm.and_(a["inf"], b["zero"]),
        vm.and_(b["inf"], a["zero"]),
    ])
    res_inf = vm.and_(vm.or_(a["inf"], b["inf"]), vm.not_(res_nan))

    out = mux_planes(vm, ge_max, _inf_planes(vm, s, fmt), normal)
    out = mux_planes(vm, res_inf, _inf_planes(vm, s, fmt), out)
    out = mux_planes(vm, res_nan, _qnan_planes(vm, fmt), out)
    return out


def float_mul(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """IEEE-754 binary32 multiplication, RNE, gradual underflow, Inf/NaN."""
    return float_mul_fmt(vm, A, B, FLOAT32)


def bf16_mul(vm: PlaneVM, A: Sequence[Plane], B: Sequence[Plane]):
    """bfloat16 multiplication (same netlist as float32, narrower mantissa)."""
    return float_mul_fmt(vm, A, B, BFLOAT16)


# --------------------------------------------------------------------------
# Schedule recording (consumed by the executors and the crossbar checks)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One registered op: its PlaneVM builder plus I/O width and dtype metadata.

    ``in_widths(nbits)`` gives the two input plane counts; ``out_width``
    the output plane count — together they define the op's I/O bits, the
    denominator of the paper's compute-complexity metric (so benchmarks
    derive widths from here instead of parsing op-name strings).

    ``arith``/``dtype`` classify the op for the ``repro_torch.pim`` tracer:
    ``arith`` is the abstract operator (``add``/``sub``/``mul``/``div``) and
    ``dtype`` the :class:`~repro_torch.core.bitplanes.PimType` kind it implements
    (``fixed``/``float32``/``bf16``).  Helper netlists that are not a typed
    arithmetic op (e.g. ``fixed_mul_unsigned``) leave them ``None``."""

    builder: Any
    in_widths: Any  # nbits -> (wa, wb)
    out_width: Any  # nbits -> wout
    arith: str | None = None
    dtype: str | None = None


_OP_TABLE = {
    "fixed_add": OpSpec(fixed_add, lambda n: (n, n), lambda n: n,
                        arith="add", dtype="fixed"),
    "fixed_sub": OpSpec(fixed_sub, lambda n: (n, n), lambda n: n,
                        arith="sub", dtype="fixed"),
    "fixed_mul": OpSpec(fixed_mul_signed, lambda n: (n, n), lambda n: 2 * n,
                        arith="mul", dtype="fixed"),
    "fixed_mul_unsigned": OpSpec(
        fixed_mul_unsigned, lambda n: (n, n), lambda n: 2 * n),
    "fixed_div": OpSpec(
        lambda vm, A, B: fixed_div_signed(vm, A, B)[0],
        lambda n: (n, n), lambda n: n, arith="div", dtype="fixed"),
    "float_add": OpSpec(float_add, lambda n: (32, 32), lambda n: 32,
                        arith="add", dtype="float32"),
    "float_sub": OpSpec(float_sub, lambda n: (32, 32), lambda n: 32,
                        arith="sub", dtype="float32"),
    "float_mul": OpSpec(float_mul, lambda n: (32, 32), lambda n: 32,
                        arith="mul", dtype="float32"),
    "float_div": OpSpec(float_div, lambda n: (32, 32), lambda n: 32,
                        arith="div", dtype="float32"),
    "bf16_add": OpSpec(bf16_add, lambda n: (16, 16), lambda n: 16,
                       arith="add", dtype="bf16"),
    "bf16_sub": OpSpec(bf16_sub, lambda n: (16, 16), lambda n: 16,
                       arith="sub", dtype="bf16"),
    "bf16_mul": OpSpec(bf16_mul, lambda n: (16, 16), lambda n: 16,
                       arith="mul", dtype="bf16"),
}

_ARITH_INDEX = {
    (spec.arith, spec.dtype): name
    for name, spec in _OP_TABLE.items() if spec.arith is not None
}


def op_for(arith: str, dtype: str) -> str:
    """The ``_OP_TABLE`` key implementing abstract ``arith`` at ``dtype``
    (a ``PimType.kind``).  Raises ``KeyError`` with the supported set when
    no netlist exists (e.g. bf16 division)."""
    try:
        return _ARITH_INDEX[(arith, dtype)]
    except KeyError:
        raise KeyError(
            f"no netlist for {arith!r} at dtype {dtype!r}; registered: "
            f"{sorted(_ARITH_INDEX)}"
        ) from None


def op_widths(op: str, nbits: int = 32) -> tuple[int, int, int]:
    """(input-a, input-b, output) plane counts of a registered op."""
    spec = _OP_TABLE[op]
    wa, wb = spec.in_widths(nbits)
    return wa, wb, spec.out_width(nbits)


def op_io_bits(op: str, nbits: int = 32) -> int:
    """Input+output bits per element — the CC denominator (paper §3)."""
    return sum(op_widths(op, nbits))


def build_schedule(op: str, nbits: int = 32, compress: bool = True):
    """Record ``op`` into a flat NOR schedule with named I/O columns.

    With ``compress`` the columns are liveness-recycled (via ``ir.lower``)
    so the whole program fits the paper's 1024-column crossbar (operands +
    intermediates)."""
    spec = _OP_TABLE[op]
    wa, wb = spec.in_widths(nbits)
    vm = PlaneVM(mode="record")
    A = [vm.input_plane() for _ in range(wa)]
    B = [vm.input_plane() for _ in range(wb)]
    out = spec.builder(vm, A, B)
    sched = vm.finish_schedule({"a": A, "b": B}, {"out": out})
    if not compress:
        return sched
    from . import ir

    return ir.lower(ir.from_schedule(sched)).to_schedule()


# --------------------------------------------------------------------------
# Gate-count census (used by the cost model and benchmarks)
# --------------------------------------------------------------------------

def count_gates(fn, *plane_widths: int) -> int:
    """Run ``fn`` on a recording VM with fresh inputs of the given widths and
    return the NOR-gate count."""
    vm = PlaneVM(mode="record")
    args = [[vm.input_plane() for _ in range(w)] for w in plane_widths]
    fn(vm, *args)
    return vm.gates


def gate_counts(nbits: int = 32) -> dict[str, int]:
    """Gate counts for the paper's Fig 3 operation set (our netlists).

    Delegates to ``ir.netlist_gate_counts`` so every caller (benchmarks,
    analyzer, simulate) shares the one compile cache."""
    from . import ir

    return ir.netlist_gate_counts(nbits)
