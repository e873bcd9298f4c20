"""The point kernels' arithmetic core, ``csrc/fq381.cuh``, built for the host.

The header's PTX carry-chain primitives have a host emulation (the same
instructions on a thread-local carry flag), so the kernels' field arithmetic and
their per-lane Jacobian formulas compile with the host's C++ compiler and run
here without a card. Held against Python integers (the field operations, on
values across the lazy range [0, 2p), extremes included) and against the plain
PyTorch versions (``point_add_plain``, ``point_double_plain``) word for word,
tolerance 0, on the edge cases of ``test_torch_curve.py`` (8 lanes each). The kernels
themselves run only on the card: ``chip_smoke.py`` holds them there against the
same plain versions.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from test_torch_curve import CASES, _edge_cases, batches  # noqa: F401 (a fixture)
from zktpu_torch.curve import point_kernels as pk
from zktpu_torch.field import torch_backend as fb
from zktpu_torch.field.spec import BLS12_381_FQ

torch.set_num_threads(1)

P = BLS12_381_FQ.modulus
R_INV = pow(1 << 384, -1, P)
ctx = fb.get_ctx(BLS12_381_FQ, device="cpu")
CSRC = os.path.join(os.path.dirname(pk.__file__), "..", "csrc")

HARNESS = r"""
#include "fq381.cuh"
using namespace fq381;
extern "C" {
void fq_op(int op, const uint32_t* a, const uint32_t* b, uint32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    const Fe& x = *(const Fe*)(a + 12 * i);
    const Fe& y = *(const Fe*)(b + 12 * i);
    Fe& o = *(Fe*)(out + 12 * i);
    switch (op) {
      case 0: mul(o, x, y); break;
      case 1: sqr(o, x); break;
      case 2: add(o, x, y); break;
      case 3: sub(o, x, y); break;
      case 4: dbl(o, x); break;
      default: canonical(o, x); break;
    }
  }
}
void g1_add(const uint32_t* const* in, uint32_t* const* out, long n) {
  for (long i = 0; i < n; ++i) {
    const long o = 12 * i;
    point_add_lane(in[0] + o, in[1] + o, in[2] + o, in[3] + o, in[4] + o, in[5] + o,
                   out[0] + o, out[1] + o, out[2] + o);
  }
}
void g1_double(const uint32_t* const* in, uint32_t* const* out, long n, int times) {
  for (long i = 0; i < n; ++i) {
    const long o = 12 * i;
    point_double_lane(in[0] + o, in[1] + o, in[2] + o, out[0] + o, out[1] + o, out[2] + o,
                      times);
  }
}
}
"""

OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3, "dbl": 4, "canonical": 5}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fq381")
    src = tmp / "harness.cpp"
    src.write_text(HARNESS)
    out = tmp / "libfq381_host.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC, str(src),
                    "-o", str(out)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _pack(values) -> np.ndarray:
    return np.array([[(v >> (32 * j)) & 0xFFFFFFFF for j in range(12)] for v in values],
                    dtype=np.uint32)


def _unpack(words) -> list[int]:
    return [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in words]


def _run(lib, op: str, a, b) -> list[int]:
    x, y = _pack(a), _pack(b)
    out = np.zeros_like(x)
    lib.fq_op(ctypes.c_int(OPS[op]), ctypes.c_void_p(x.ctypes.data),
              ctypes.c_void_p(y.ctypes.data), ctypes.c_void_p(out.ctypes.data),
              ctypes.c_long(len(a)))
    return _unpack(out)


def _lazy_values():
    """Values across [0, 2p): edges, words of all ones under the top word,
    random ones, and every pair of the edges."""
    rng = np.random.default_rng(3)
    edges = [0, 1, 2, P // 2, P - 1, P, P + 1, 2 * P - 2, 2 * P - 1, 1 << 380,
             (0x34022300 << 352) | ((1 << 352) - 1), (0x1A0111E9 << 352) | ((1 << 352) - 1)]
    rand = [int.from_bytes(rng.bytes(48), "little") % (2 * P) for _ in range(400)]
    a = [x for x in edges for _ in edges] + rand
    b = [y for _ in edges for y in edges] + rand[::-1]
    return a, b


@pytest.mark.parametrize("op", list(OPS))
def test_field_ops_against_python_ints(lib, op):
    a, b = _lazy_values()
    got = _run(lib, op, a, b)
    want = {
        "mul": [x * y * R_INV % P for x, y in zip(a, b)],
        "sqr": [x * x * R_INV % P for x in a],
        "add": [(x + y) % P for x, y in zip(a, b)],
        "sub": [(x - y) % P for x, y in zip(a, b)],
        "dbl": [2 * x % P for x in a],
        "canonical": [x % P for x in a],
    }[op]
    limit = P if op == "canonical" else 2 * P
    assert all(g < limit for g in got)
    assert [g % P for g in got] == want


@pytest.fixture(scope="module")
def cases(batches):
    return _edge_cases(batches)


def _ptrs(arrays):
    return (ctypes.c_void_p * len(arrays))(*(a.ctypes.data for a in arrays))


def _words(pt):
    return [np.ascontiguousarray(t.numpy().view(np.uint32)) for t in pt]


@pytest.mark.parametrize("name", CASES)
def test_point_add_lane_equals_plain(lib, cases, name):
    p1, p2 = cases[name]
    ins = _words(p1) + _words(p2)
    outs = [np.zeros_like(ins[0]) for _ in range(3)]
    lib.g1_add(_ptrs(ins), _ptrs(outs), ctypes.c_long(8))
    want = _words(pk.point_add_plain(ctx, p1, p2))
    assert all(np.array_equal(g, w) for g, w in zip(outs, want))


@pytest.mark.parametrize("name,times", [("random_affine", 1), ("z_not_one_both", 3),
                                        ("infinity_mixed_lanes", 16),
                                        ("coordinates_0_and_p_minus_1", 2)])
def test_point_double_lane_equals_plain(lib, cases, name, times):
    pt = cases[name][0]
    ins = _words(pt)
    outs = [np.zeros_like(ins[0]) for _ in range(3)]
    lib.g1_double(_ptrs(ins), _ptrs(outs), ctypes.c_long(8), ctypes.c_int(times))
    want = _words(pk.point_double_plain(ctx, pt, times))
    assert all(np.array_equal(g, w) for g, w in zip(outs, want))
