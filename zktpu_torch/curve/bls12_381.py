"""BLS12-381 host-side curve arithmetic and pairing.

This package's own copy of ``zktpu/curve/bls12_381.py`` (host integers only).
The reference leans on arkworks' ``ark_bls12_381`` for G1/G2 group ops and the
pairing product check in KZG verification (pcs/src/kzg_pcs/kzg.rs:97-128). Here
the *hot* group operations (MSM, batched scalar multiplication for the Lagrange
SRS) run on the device through the point kernels (``zktpu_torch.curve.device``,
``zktpu_torch.msm``); this module is the exact host oracle: verifier-side
pairings, small scalar muls, and test vectors. Everything is textbook affine
arithmetic over Python ints.

Pairing design: the ate Miller loop runs over E(Fq12) with the G2 point
untwisted into Fq12 = Fq[w]/(w^12 - 2w^6 + 2) (in this basis u = w^6 - 1 has
u^2 = -1, embedding Fq2; the M-twist y^2 = x^3 + 4(u+1) untwists by dividing
coordinates by w^2, w^3). Verification equations only need bilinearity and a
single final exponentiation over the *product* of Miller values, so the
verifier does exactly one (p^12-1)/r exponentiation per pairing-product
check.

Lineage note: the generic FQ/FQP extension-field classes (polynomial
reduction, extended-Euclid inverse) and the affine line-function Miller-loop
structure follow the well-known public py_ecc (Ethereum Foundation, MIT)
implementation pattern, re-derived here for BLS12-381: the Fq12 tower basis
w^12 - 2w^6 + 2, the u = w^6 - 1 embedding of Fq2, the M-twist untwist map,
and the single-final-exponentiation pairing-product check are original to
this module.
"""

from __future__ import annotations

from ..field.spec import BLS12_381_FQ, BLS12_381_FR

P = BLS12_381_FQ.modulus
R_ORDER = BLS12_381_FR.modulus

# BLS parameter x = -0xd201000000010000; the ate loop runs over |x|
ATE_LOOP_COUNT = 0xD201000000010000


# ----------------------------------------------------------------------
# extension fields: generic polynomial extension over Fq
# ----------------------------------------------------------------------

class FQ:
    """Base field element (thin wrapper so FQ/FQP share operator protocol)."""

    __slots__ = ("n",)
    degree = 1

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, o):
        return FQ(self.n + (o.n if isinstance(o, FQ) else o))

    __radd__ = __add__

    def __sub__(self, o):
        return FQ(self.n - (o.n if isinstance(o, FQ) else o))

    def __rsub__(self, o):
        return FQ((o if isinstance(o, int) else o.n) - self.n)

    def __mul__(self, o):
        return FQ(self.n * (o.n if isinstance(o, FQ) else o))

    __rmul__ = __mul__

    def __neg__(self):
        return FQ(-self.n)

    def inv(self):
        return FQ(pow(self.n, -1, P))

    def __truediv__(self, o):
        return self * (o.inv() if isinstance(o, FQ) else FQ(o).inv())

    def __pow__(self, e: int):
        return FQ(pow(self.n, e, P))

    def __eq__(self, o):
        return self.n == (o.n if isinstance(o, FQ) else o % P)

    def __hash__(self):
        return hash(self.n)

    def __repr__(self):
        return f"FQ({self.n})"

    @classmethod
    def one(cls):
        return FQ(1)

    @classmethod
    def zero(cls):
        return FQ(0)


def _poly_rounded_div(a, b):
    """Quotient of coefficient-list polynomials over Fq (for ext-gcd)."""
    dega = _deg(a)
    degb = _deg(b)
    temp = list(a)
    out = [0] * len(a)
    inv_lead = pow(b[degb], -1, P)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * inv_lead) % P
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[i] * b[c]) % P
    return out[: _deg(out) + 1]


def _deg(p):
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


class FQP:
    """Element of Fq[x]/(x^deg + sum modulus_coeffs[i] x^i)."""

    degree = 0
    modulus_coeffs: tuple = ()

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = [c % P if isinstance(c, int) else c.n for c in coeffs]

    def __add__(self, other):
        return type(self)([(a + b) % P for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([(a - b) % P for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-c % P for c in self.coeffs])

    def __mul__(self, other):
        if isinstance(other, int):
            return type(self)([c * other % P for c in self.coeffs])
        d = self.degree
        b = [0] * (2 * d - 1)
        for i, ca in enumerate(self.coeffs):
            if ca:
                for j, cb in enumerate(other.coeffs):
                    b[i + j] = (b[i + j] + ca * cb) % P
        # reduce x^(d+k) -> -sum modulus_coeffs[i] x^(i+k)
        for exp in range(2 * d - 2, d - 1, -1):
            top = b[exp]
            if top:
                b[exp] = 0
                for i, mc in enumerate(self.modulus_coeffs):
                    if mc:
                        b[exp - d + i] = (b[exp - d + i] - top * mc) % P
        return type(self)(b[:d])

    __rmul__ = __mul__

    def __pow__(self, e: int):
        result = type(self).one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """Extended Euclid over Fq[x]."""
        lm, hm = [1] + [0] * self.degree, [0] * (self.degree + 1)
        low = self.coeffs + [0]
        high = list(self.modulus_coeffs) + [1]
        while _deg(low):
            r = _poly_rounded_div(high, low)
            r += [0] * (self.degree + 1 - len(r))
            nm = list(hm)
            new = list(high)
            for i in range(self.degree + 1):
                for j in range(self.degree + 1 - i):
                    nm[i + j] = (nm[i + j] - lm[i] * r[j]) % P
                    new[i + j] = (new[i + j] - low[i] * r[j]) % P
            lm, low, hm, high = nm, new, lm, low
        inv_c0 = pow(low[0], -1, P)
        return type(self)([c * inv_c0 % P for c in lm[: self.degree]])

    def __truediv__(self, other):
        if isinstance(other, int):
            return self * pow(other, -1, P)
        return self * other.inv()

    def __eq__(self, other):
        return type(self) is type(other) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash(tuple(self.coeffs))

    def __repr__(self):
        return f"{type(self).__name__}({self.coeffs})"

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)


class FQ2(FQP):
    degree = 2
    modulus_coeffs = (1, 0)  # u^2 = -1


class FQ12(FQP):
    degree = 12
    modulus_coeffs = (2, 0, 0, 0, 0, 0, -2, 0, 0, 0, 0, 0)  # w^12 = 2w^6 - 2


# ----------------------------------------------------------------------
# curve arithmetic (affine, generic over the coordinate field)
# ----------------------------------------------------------------------

B1 = FQ(4)
B2 = FQ2([4, 4])  # 4*(u+1): the M-twist constant of the real G2 curve

G1_GEN = (
    FQ(0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB),
    FQ(0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1),
)
G2_GEN = (
    FQ2([
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ]),
    FQ2([
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ]),
)

INF = None  # point at infinity


def is_on_curve(pt, b):
    if pt is None:
        return True
    x, y = pt
    return y * y - x * x * x == b


def double(pt):
    if pt is None:
        return None
    x, y = pt
    zero = type(y).zero() if hasattr(y, "coeffs") else FQ(0)
    if y == zero:
        return None
    m = (x * x * 3) / (y * 2)
    nx = m * m - x - x
    ny = m * (x - nx) - y
    return (nx, ny)


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return double(p1)
        return None
    m = (y2 - y1) / (x2 - x1)
    nx = m * m - x1 - x2
    ny = m * (x1 - nx) - y1
    return (nx, ny)


def neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, -y)


def multiply(pt, n: int):
    n %= R_ORDER
    result = None
    addend = pt
    while n:
        if n & 1:
            result = add(result, addend)
        addend = double(addend)
        n >>= 1
    return result


def eq_pt(p1, p2):
    return p1 == p2


# ----------------------------------------------------------------------
# pairing
# ----------------------------------------------------------------------

# w^-2 and w^-3 for the untwist map (divide coordinates by w^2, w^3)
_W = FQ12([0, 1] + [0] * 10)
_W2_INV = (_W * _W).inv()
_W3_INV = (_W * _W * _W).inv()


def _embed_fq2(a: FQ2) -> FQ12:
    """Fq2 -> Fq12 via u = w^6 - 1: a0 + a1*u = (a0 - a1) + a1*w^6."""
    c = [0] * 12
    c[0] = (a.coeffs[0] - a.coeffs[1]) % P
    c[6] = a.coeffs[1]
    return FQ12(c)


def untwist(pt):
    """E'(Fq2) -> E(Fq12): (x, y) -> (x/w^2, y/w^3)."""
    if pt is None:
        return None
    x, y = pt
    return (_embed_fq2(x) * _W2_INV, _embed_fq2(y) * _W3_INV)


def _embed_fq(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x.n] + [0] * 11), FQ12([y.n] + [0] * 11))


def _linefunc(p1, p2, t):
    """Evaluate the line through p1, p2 at t (all affine E(Fq12) points)."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1 * 3) / (y1 * 2)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q_g2, p_g1) -> FQ12:
    """Ate Miller value f_{|x|,Q}(P) (no final exponentiation).

    The BLS parameter is negative; the verifier only forms pairing-*products*
    compared for equality, and a globally consistent bilinear map is all that
    is required, so the conjugation for the sign is unnecessary.
    """
    if q_g2 is None or p_g1 is None:
        return FQ12.one()
    q = untwist(q_g2)
    pt = _embed_fq(p_g1)
    r = q
    f = FQ12.one()
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = f * f * _linefunc(r, r, pt)
        r = add(r, r)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(r, q, pt)
            r = add(r, q)
    return f


FINAL_EXP = (P**12 - 1) // R_ORDER


def final_exponentiation(f: FQ12) -> FQ12:
    return f ** FINAL_EXP


def pairing(p_g1, q_g2) -> FQ12:
    """e(P, Q) in GT (arkworks ``Bls12_381::pairing`` argument order)."""
    return final_exponentiation(miller_loop(q_g2, p_g1))


def pairing_product_equals(lhs_pairs, rhs_pairs) -> bool:
    """Check prod e(lhs) == prod e(rhs) with a single final exponentiation.

    Each entry is an (P_g1, Q_g2) pair. Uses e(-P, Q) = e(P, Q)^-1 to move
    the rhs across.
    """
    acc = FQ12.one()
    for p_g1, q_g2 in lhs_pairs:
        acc = acc * miller_loop(q_g2, p_g1)
    for p_g1, q_g2 in rhs_pairs:
        acc = acc * miller_loop(q_g2, neg(p_g1))
    return final_exponentiation(acc) == FQ12.one()
