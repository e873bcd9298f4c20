"""zktpu_torch's device Keccak (plain PyTorch, int64 lanes) vs the host Keccak
and vs zktpu's device Keccak.

The same bytes go through ``zktpu_torch.hash.keccak_device`` on the CPU, the
port's host sponge, and ``zktpu.hash.keccak_device``. Tolerance 0: digests and
sponge states are compared bit for bit.
"""

import numpy as np
import pytest
import torch

from zktpu.hash import keccak as jhk
from zktpu.hash import keccak_device as jkd

from zktpu_torch import convert
from zktpu_torch.hash import keccak as hk
from zktpu_torch.hash import keccak_device as kd

torch.set_num_threads(1)


def _message(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("length", [0, 1, 135, 136, 137, 1000])
def test_keccak256_device(length):
    data = _message(length)
    lanes = kd.keccak256_device(data, "cpu")
    assert lanes.dtype == torch.int64 and tuple(lanes.shape) == (4,)
    digest = kd.digest_to_bytes(lanes)
    assert digest == hk.keccak256(data)
    assert digest == jhk.keccak256(data)
    jax_lanes = jkd.keccak256_device(data)
    assert digest == jkd.digest_to_bytes(jax_lanes)
    assert torch.equal(lanes, convert.sponge_state_from_zktpu(np.asarray(jax_lanes)))


def test_host_keccak_copy_is_native_and_equal():
    assert hk.backend() == "c"
    data = _message(5000)
    assert hk.keccak256(data) == jhk.keccak256(data) == hk._keccak256_py(data)
    sponge, jsponge = hk.Sponge(), jhk.Sponge()
    for chunk in (data[:100], data[100:3000], data[3000:]):
        sponge.absorb(chunk)
        jsponge.absorb(chunk)
    assert sponge.digest() == jsponge.digest() == hk.keccak256(data)
    state, tail = sponge.state_lanes()
    jstate, jtail = jsponge.state_lanes()
    assert tail == jtail and np.array_equal(state, jstate)


def test_absorb_block_continues_the_host_sponge():
    """The device handoff: the host absorbs the full blocks, the device absorbs
    the padded tail; the state and the digest must be the host's."""
    data = _message(136 * 3 + 40)
    sponge = hk.Sponge()
    sponge.absorb(data)
    pairs, tail = sponge.state_lanes()
    state = torch.from_numpy(kd.pairs_to_lanes(pairs))
    assert torch.equal(state, convert.sponge_state_from_zktpu(pairs))
    block = bytearray(tail.ljust(kd.RATE, b"\0"))
    block[len(tail)] ^= 0x01
    block[kd.RATE - 1] ^= 0x80
    out = kd.absorb_block(state, torch.from_numpy(kd.bytes_to_lanes(bytes(block))))
    assert kd.digest_to_bytes(out[:4]) == hk.keccak256(data)
    jout = jkd.absorb_block(np.asarray(pairs), jkd.bytes_to_lanes(bytes(block)))
    assert np.array_equal(convert.sponge_state_to_zktpu(out), np.asarray(jout))


def test_limbs_to_lanes_and_back():
    rng = np.random.default_rng(5)
    digits = rng.integers(0, 1 << 16, size=(3, 16), dtype=np.uint32)
    digits[0] = 0xFFFF  # every sign bit set in the int32 / int64 storage
    words = convert.table_from_zktpu(digits)
    lanes = kd.limbs_to_lanes(words)
    assert lanes.dtype == torch.int64 and tuple(lanes.shape) == (3, 4)
    jax_lanes = np.asarray(jkd.limbs_to_lanes(digits))  # (3, 4, 2) pairs
    for row in range(3):
        assert torch.equal(lanes[row], convert.sponge_state_from_zktpu(jax_lanes[row]))
    back = kd.lanes_to_limbs(lanes)
    assert back.dtype == torch.int32 and torch.equal(back, words)
    assert np.array_equal(
        convert.table_to_zktpu(back), np.asarray(jkd.lanes_to_limbs(jax_lanes))
    )
    # the bytes of a lane row are the little-endian bytes of the words
    assert lanes.numpy().astype("<i8").tobytes() == words.numpy().astype("<i4").tobytes()
