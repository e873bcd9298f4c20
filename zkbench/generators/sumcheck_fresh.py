"""Generator of plain sumcheck proofs: one caller proves the sum of a table
that lies on the card, proofs back to back, each to its end, each of a fresh
``MultilinearPoly``: nothing of an earlier proof is cached, so every proof
pays its table's canonical words and transcript prefix.

The entry is ``sumcheck.fused.prove``. Mix parameters: ``pool`` (tables put on
the card in set-up, at least two, taken in turn so that no proof repeats its
predecessor's table), ``warmup_proofs``, ``checked_proofs`` (proofs of the
window, drawn from the seed, held against the reference).

Configuration: ``num_vars`` (log2 of the table's entries), ``input_bits``,
``field`` (``modulus``, BN254 Fq).
"""

from __future__ import annotations

import gc
import os
import time

import torch

from ..harness import closed_loop, streams
from ..harness.compare import mismatches
from ..reference import sumcheck as reference


def draw_table(config: dict, seed: int, index: int) -> list[int]:
    rng = streams.generator(seed, "table", index)
    return rng.integers(0, 1 << config["input_bits"], size=1 << config["num_vars"]).tolist()


def proof_values(proof) -> dict:
    """A proof of ``fused.prove`` as plain Python values, named as the
    reference names them."""
    return {"claimed_sum": proof.claimed_sum,
            "round_polys": [list(p) for p in proof.proof_polynomials]}


class Generator:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        if mix["pool"] < 2:
            raise ValueError("the pool needs at least two tables")

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        from zktpu_torch import _build
        from zktpu_torch.field import torch_backend as fb
        from zktpu_torch.field.spec import BN254_FQ
        from zktpu_torch.poly.multilinear import MultilinearPoly

        t0 = time.time()
        if self.on_card:
            stems = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
            _build.build_cuda_libraries(stems)
        if int(self.config["field"]["modulus"], 0) != BN254_FQ.modulus:
            raise ValueError("the sumcheck generator runs BN254 Fq")
        t1 = time.time()
        self.ctx = fb.get_ctx(BN254_FQ, self.device)
        # only the device table is kept: a table an earlier stage made on the card
        self.pool = [MultilinearPoly.from_ints(self.ctx, draw_table(self.config, self.seed, j)).table
                     for j in range(self.mix["pool"])]
        self._sync()
        t2 = time.time()
        for w in range(self.mix["warmup_proofs"]):
            self._prove(self.pool[-1 - w % len(self.pool)])
            self._sync()
        self.setup_stages = [("libraries", t1 - t0), ("tables", t2 - t1),
                             ("warm-up", time.time() - t2)]

    def _prove(self, table):
        from zktpu_torch.poly.multilinear import MultilinearPoly
        from zktpu_torch.sumcheck import fused

        return fused.prove(MultilinearPoly(self.ctx, table))

    def window(self, seconds: float) -> dict:
        self.proofs, window = closed_loop.window(self._prove, self.pool, seconds, self._sync)
        return window

    def release(self) -> None:
        """Take the proofs to plain values and drop the program's state."""
        self.values = [proof_values(p) for p in self.proofs]
        del self.proofs, self.pool, self.ctx
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Mismatched values of the sampled proofs against the reference, and
        the proofs that had any."""
        rng = streams.generator(self.seed, "check")
        count = min(self.mix["checked_proofs"], len(self.values))
        picks = sorted(rng.choice(len(self.values), size=count, replace=False).tolist())
        bad_values, bad_proofs = 0, 0
        for i in picks:
            table = draw_table(self.config, self.seed, i % self.mix["pool"])
            n = mismatches(self.values[i], reference.prove(table, self.device))
            bad_values += n
            bad_proofs += n > 0
        return {"checked": picks, "failed": bad_proofs,
                "numbers": [("mismatched_values", bad_values, 0)]}


def control(config: dict, mix: dict, seed: int, device) -> list:
    """The control at this configuration's size: the reference with the
    guarantee that the transcript binds the claimed sum broken, in the
    program's place, against the reference. Returns the numbers the check
    compares."""
    table = draw_table(config, seed, 0)
    want = reference.prove(table, device)
    got = reference.prove(table, device, bind_claim=False)
    return [("mismatched_values", mismatches(got, want), 0)]
