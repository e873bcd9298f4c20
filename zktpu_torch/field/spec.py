"""Field specifications.

A ``FieldSpec`` carries everything a kernel or host routine needs to do
arithmetic in a prime field: the modulus, its width, the Montgomery constants,
the serialization width, and (where present) a two-adic root of unity for NTTs.

The reference implementation (obah/zk-research-implementations) hard-codes its
fields per crate via arkworks generics: KZG and GKR on BLS12-381 Fr, the FFT on
BN254 Fr, Shamir and most tests on BN254 Fq. Here the same choice is a config
object threaded through the kernels.

Width: ``num_limbs`` counts 16-bit digits, as in the JAX package, so that the
Montgomery radix ``R = 2^(16 * num_limbs)`` is the same number in both and
Montgomery values agree bit for bit. On the device an element is stored as
``num_words = num_limbs // 2`` little-endian 32-bit words, because the GPU
multiplies 32x32->64 natively; ``n0_prime32`` is the CIOS factor for that word
size. The plain PyTorch arithmetic works on the 16-bit digits (in int64 lanes)
and uses ``n0_prime``.
"""

from __future__ import annotations

import dataclasses
import functools

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
WORD_BITS = 32
WORD_MASK = (1 << WORD_BITS) - 1


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field."""

    name: str
    modulus: int
    #: number of 16-bit digits of the representation (even)
    num_limbs: int
    #: serialized byte width, matching arkworks BigInt::to_bytes_le
    #: (8 * number of 64-bit limbs arkworks uses)
    byte_len: int
    #: largest s such that 2^s | (modulus - 1)
    two_adicity: int = 0
    #: generator of the 2^two_adicity subgroup (arkworks TWO_ADIC_ROOT_OF_UNITY)
    two_adic_root_of_unity: int = 0

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def num_words(self) -> int:
        """Number of 32-bit words of the device representation."""
        return self.num_limbs // 2

    # ------------------------------------------------------------------
    # Montgomery constants (R = 2^(16 * num_limbs) = 2^(32 * num_words))
    # ------------------------------------------------------------------
    @property
    def r_bits(self) -> int:
        return LIMB_BITS * self.num_limbs

    @functools.cached_property
    def R(self) -> int:  # noqa: N802 - Montgomery radix, conventional name
        return (1 << self.r_bits) % self.modulus

    @functools.cached_property
    def R2(self) -> int:  # noqa: N802
        return (1 << (2 * self.r_bits)) % self.modulus

    @functools.cached_property
    def n0_prime(self) -> int:
        """-modulus^{-1} mod 2^16 (the CIOS factor of the 16-bit plain path)."""
        inv = pow(self.modulus, -1, 1 << LIMB_BITS)
        return (-inv) % (1 << LIMB_BITS)

    @functools.cached_property
    def n0_prime32(self) -> int:
        """-modulus^{-1} mod 2^32 (the CIOS factor of the 32-bit kernels)."""
        inv = pow(self.modulus, -1, 1 << WORD_BITS)
        return (-inv) % (1 << WORD_BITS)

    # ------------------------------------------------------------------
    # host <-> digit/word conversions
    # ------------------------------------------------------------------
    def to_limbs(self, value: int) -> list[int]:
        value %= self.modulus
        return [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(self.num_limbs)]

    def from_limbs(self, limbs) -> int:
        acc = 0
        for i, limb in enumerate(limbs):
            acc |= int(limb) << (LIMB_BITS * i)
        return acc

    def to_words(self, value: int) -> list[int]:
        value %= self.modulus
        return [(value >> (WORD_BITS * i)) & WORD_MASK for i in range(self.num_words)]

    def from_words(self, words) -> int:
        acc = 0
        for i, word in enumerate(words):
            acc |= (int(word) & WORD_MASK) << (WORD_BITS * i)
        return acc

    # ------------------------------------------------------------------
    # byte serialization: little-endian canonical bigint bytes, the exact
    # layout of arkworks `into_bigint().to_bytes_le()` used by the reference's
    # fq_vec_to_bytes (fiat_shamir/src/fiat_shamir_transcript.rs:32-37)
    # ------------------------------------------------------------------
    def to_bytes_le(self, value: int) -> bytes:
        return (value % self.modulus).to_bytes(self.byte_len, "little")

    def from_le_bytes_mod_order(self, data: bytes) -> int:
        """arkworks F::from_le_bytes_mod_order semantics."""
        return int.from_bytes(data, "little") % self.modulus

    def root_of_unity(self, n: int) -> int:
        """n-th root of unity, matching arkworks ``F::get_root_of_unity(n)``."""
        if n <= 0 or n & (n - 1):
            raise ValueError("n must be a power of two")
        log_n = n.bit_length() - 1
        if log_n > self.two_adicity:
            raise ValueError(f"field {self.name} has no 2^{log_n}-th root of unity")
        root = self.two_adic_root_of_unity
        for _ in range(self.two_adicity - log_n):
            root = root * root % self.modulus
        return root


# ----------------------------------------------------------------------
# Concrete fields used by the reference workspace
# ----------------------------------------------------------------------

#: BN254 (alt_bn128) base field. Reference: Shamir, Merkle & most poly tests.
BN254_FQ = FieldSpec(
    name="bn254_fq",
    modulus=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    num_limbs=16,
    byte_len=32,
)

#: BN254 scalar field. Reference: the FFT crate.
BN254_FR = FieldSpec(
    name="bn254_fr",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    num_limbs=16,
    byte_len=32,
    two_adicity=28,
    # arkworks ark_bn254::Fr TWO_ADIC_ROOT_OF_UNITY (generator 5)
    two_adic_root_of_unity=pow(
        5,
        (21888242871839275222246405745257275088548364400416034343698204186575808495617 - 1)
        >> 28,
        21888242871839275222246405745257275088548364400416034343698204186575808495617,
    ),
)

#: BLS12-381 scalar field. Reference: KZG & GKR protocol fields.
BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    modulus=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    num_limbs=16,
    byte_len=32,
    two_adicity=32,
    # arkworks ark_bls12_381::Fr TWO_ADIC_ROOT_OF_UNITY (generator 7)
    two_adic_root_of_unity=pow(
        7,
        (0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001 - 1) >> 32,
        0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    ),
)

#: BLS12-381 base field (curve coordinates; 48-byte serialization).
BLS12_381_FQ = FieldSpec(
    name="bls12_381_fq",
    modulus=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    num_limbs=24,
    byte_len=48,
)

ALL_SPECS = (BN254_FQ, BN254_FR, BLS12_381_FR, BLS12_381_FQ)
