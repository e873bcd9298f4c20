"""Keccak Merkle tree over field elements.

Capability parity with the reference's merkle_tree/src/merkle_tree.rs:
fixed-depth binary tree whose node values are *field elements* -- each hash
output is mapped back into F via ``from_le_bytes_mod_order`` (:201-214);
zero-filled ``new`` (:32-52), hash-then-pad ``new_with_inputs`` (:54-82),
O(depth) ``update_leaf``/``recompute_path`` (:84-132), sibling-path proofs
with side flags (:138-183) and ``verify`` (:185-199).

Hashing: whole levels are hashed in one native batched Keccak call
(C via ctypes) -- the construction is breadth-first data parallel, the exact
opposite of the reference's per-pair loop. Byte layout of the preimages is
``fq_vec_to_bytes`` (little-endian canonical bigints), so every node value is
bit-exact with the reference.
"""

from __future__ import annotations

import dataclasses
import enum

from ..field.spec import FieldSpec, BN254_FQ
from ..field.host import vec_to_bytes
from ..hash.keccak import keccak256, keccak256_batch


class LeafSide(enum.Enum):
    LEFT = "left"
    RIGHT = "right"


@dataclasses.dataclass
class ProofData:
    data_hash: int
    data_side: LeafSide


@dataclasses.dataclass
class MerkleProof:
    data: int
    proof: list[ProofData]


class MerkleTree:
    def __init__(self, spec: FieldSpec, depth: int):
        self.spec = spec
        self.depth = depth
        self.leaves = [0] * (1 << depth)
        self._build()

    @classmethod
    def new_with_inputs(cls, spec: FieldSpec, depth: int, inputs: list[int]) -> "MerkleTree":
        if len(inputs) > (1 << depth):
            raise ValueError("Too many inputs for tree depth")
        tree = cls.__new__(cls)
        tree.spec = spec
        tree.depth = depth
        tree.leaves = [0] * (1 << depth)
        hashed = tree._hash_many(inputs)
        tree.leaves[: len(inputs)] = hashed
        tree._build()
        return tree

    # -- hashing -----------------------------------------------------------

    def compute_hash(self, data: int) -> int:
        return self.spec.from_le_bytes_mod_order(
            keccak256(vec_to_bytes(self.spec, [data]))
        )

    def hash_pair(self, left: int, right: int) -> int:
        return self.spec.from_le_bytes_mod_order(
            keccak256(vec_to_bytes(self.spec, [left, right]))
        )

    def _hash_many(self, values: list[int]) -> list[int]:
        if not values:
            return []
        blob = vec_to_bytes(self.spec, values)
        digests = keccak256_batch(blob, self.spec.byte_len)
        return [
            self.spec.from_le_bytes_mod_order(digests[32 * i : 32 * i + 32])
            for i in range(len(values))
        ]

    def _hash_level(self, level: list[int]) -> list[int]:
        blob = vec_to_bytes(self.spec, level)
        digests = keccak256_batch(blob, 2 * self.spec.byte_len)
        return [
            self.spec.from_le_bytes_mod_order(digests[32 * i : 32 * i + 32])
            for i in range(len(level) // 2)
        ]

    # -- construction ------------------------------------------------------

    def _build(self) -> None:
        self.tree: list[list[int]] = []
        current = self.leaves
        for _ in range(self.depth):
            current = self._hash_level(current)
            self.tree.append(current)

    # -- API ---------------------------------------------------------------

    def get_root_hash(self) -> int:
        return self.tree[self.depth - 1][0]

    def update_leaf(self, leaf_id: int, data: int, is_hash: bool) -> None:
        if leaf_id >= (1 << self.depth):
            raise ValueError("Invalid leaf ID")
        self.leaves[leaf_id] = data if is_hash else self.compute_hash(data)
        self._recompute_path(leaf_id)

    def _recompute_path(self, leaf_id: int) -> None:
        current = self.leaves[leaf_id]
        index = leaf_id
        for level in range(self.depth):
            sibling = (
                self.leaves[index ^ 1] if level == 0 else self.tree[level - 1][index ^ 1]
            )
            left, right = (current, sibling) if index % 2 == 0 else (sibling, current)
            current = self.hash_pair(left, right)
            index //= 2
            self.tree[level][index] = current

    def create_proof(self, data_to_prove: int, leaf_id: int) -> MerkleProof:
        if leaf_id >= (1 << self.depth):
            raise ValueError("Invalid leaf ID")
        if self.leaves[leaf_id] != self.compute_hash(data_to_prove):
            raise ValueError("Data does not match the leaf hash")
        proof = []
        index = leaf_id
        for level in range(self.depth):
            sibling = (
                self.leaves[index ^ 1] if level == 0 else self.tree[level - 1][index ^ 1]
            )
            side = LeafSide.RIGHT if index % 2 == 0 else LeafSide.LEFT
            proof.append(ProofData(sibling, side))
            index //= 2
        return MerkleProof(data_to_prove, proof)

    def verify(self, proof: MerkleProof) -> bool:
        current = self.compute_hash(proof.data)
        for pd in proof.proof:
            if pd.data_side == LeafSide.LEFT:
                current = self.hash_pair(pd.data_hash, current)
            else:
                current = self.hash_pair(current, pd.data_hash)
        return current == self.get_root_hash()


DEFAULT_SPEC = BN254_FQ
