"""Fiat-Shamir transcript, byte-exact with the reference.

Replicates the reference's fiat_shamir/src/fiat_shamir_transcript.rs:
  * ``append``  == ``hasher.update``  (:19-21)
  * ``get_random_challenge`` == ``finalize_reset()`` then re-append the 32-byte
    digest as the new state seed, then map to the field via
    ``from_le_bytes_mod_order`` (:23-29).

A streaming Keccak hasher that supports finalize-then-reset is equivalent to
hashing the concatenation of everything appended since the last reset, so the
transcript keeps a byte buffer and hashes it on each squeeze; after a squeeze
the buffer is replaced by the digest (= "reset, then append digest").

This byte protocol is the bit-exactness contract for the whole framework
(SURVEY.md section 2, item 4): every challenge in sumcheck/GKR is derived
through it.
"""

from __future__ import annotations

from .field.spec import FieldSpec
from .field.host import vec_to_bytes
from .hash.keccak import Sponge


class Transcript:
    """Streaming implementation: appends absorb into a Keccak sponge
    incrementally (C backend), so a squeeze never rehashes earlier bytes.
    Digest-equivalent to hashing the concatenated buffer, hence byte-exact
    with the reference.

    ``seed`` lets callers start from a pre-absorbed sponge (e.g. the cached
    state of a large evaluation table, MultilinearPoly.transcript_sponge) --
    pure memoization, identical challenge stream.
    """

    def __init__(self, spec: FieldSpec, seed: Sponge | None = None):
        self.spec = spec
        self._sponge = seed.copy() if seed is not None else Sponge()

    def append(self, preimage: bytes) -> None:
        self._sponge.absorb(preimage)

    def append_field_elements(self, values) -> None:
        """append(fq_vec_to_bytes(values)) -- the common call pattern."""
        self.append(vec_to_bytes(self.spec, values))

    def get_random_challenge(self) -> int:
        digest = self._sponge.digest()
        self._sponge = Sponge()
        self._sponge.absorb(digest)
        return self.spec.from_le_bytes_mod_order(digest)

    def sponge(self) -> Sponge:
        """Snapshot of the current sponge (for the on-device continuation)."""
        return self._sponge.copy()
