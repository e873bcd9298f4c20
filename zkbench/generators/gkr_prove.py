"""Generator of GKR proofs: one caller proves equal-size statements of one circuit
back to back, each proof to its end.

The entry is ``gkr.protocol.prove``: the whole proof with its KZG input proof.
Mix parameters: ``pool`` (input sets made in set-up, at least two, taken in
turn so that no proof repeats its predecessor's witness), ``warmup_proofs``,
``checked_proofs`` (proofs of the window, drawn from the seed, held against the
reference).

Configuration: ``num_vars`` (log2 of the inputs; the halving circuit has as
many layers), ``input_bits``, ``tau_low``, ``tau_high_bits``.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from ..harness import streams
from ..harness.compare import mismatches
from ..reference import gkr as reference


def draw_circuit(config: dict, seed: int) -> list[np.ndarray]:
    """Per layer, inputs first, whether each gate adds."""
    rng = streams.generator(seed, "circuit")
    return [rng.integers(2, size=1 << k).astype(bool)
            for k in range(config["num_vars"] - 1, -1, -1)]


def draw_taus(config: dict, seed: int) -> list[int]:
    rng = streams.generator(seed, "taus")
    return rng.integers(config["tau_low"], 1 << config["tau_high_bits"],
                        size=config["num_vars"]).tolist()


def draw_inputs(config: dict, seed: int, index: int) -> list[int]:
    rng = streams.generator(seed, "inputs", index)
    return rng.integers(0, 1 << config["input_bits"], size=1 << config["num_vars"]).tolist()


def _point(pt):
    return None if pt is None else (int(pt[0].n), int(pt[1].n))


def proof_values(proof) -> dict:
    """A proof of ``prove`` as plain Python values, named as the reference
    names them."""
    kzg = proof.input_proof
    return {
        "output": proof.output_poly.to_ints(),
        "round_polys": [[list(p.coefficients) for p in layer] for layer in proof.proof_polynomials],
        "claimed": [tuple(c) for c in proof.claimed_evaluations],
        "opened": list(kzg.opened_evals),
        "commitment": _point(kzg.commitment),
        "quotients": [[_point(q) for q in qs] for qs in kzg.proof],
    }


class Generator:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        if mix["pool"] < 2:
            raise ValueError("the pool needs at least two input sets")

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        from zktpu_torch import _build
        from zktpu_torch.field import torch_backend as fb
        from zktpu_torch.field.spec import BLS12_381_FR
        from zktpu_torch.gkr.circuit import Circuit

        t0 = time.time()
        if self.on_card:
            stems = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
            _build.build_cuda_libraries(stems)
        t1 = time.time()
        masks = draw_circuit(self.config, self.seed)
        self.taus = draw_taus(self.config, self.seed)
        self.pool = [draw_inputs(self.config, self.seed, j) for j in range(self.mix["pool"])]
        ctx = fb.get_ctx(BLS12_381_FR, self.device)
        self.circuit = Circuit(ctx, [np.where(m, "add", "mul").tolist() for m in masks])
        t2 = time.time()
        for w in range(self.mix["warmup_proofs"]):
            self._prove(self.pool[-1 - w % len(self.pool)])
            self._sync()
        self.setup_stages = [("libraries", t1 - t0), ("inputs and circuit", t2 - t1),
                             ("warm-up", time.time() - t2)]

    def _prove(self, inputs):
        from zktpu_torch.gkr import protocol

        return protocol.prove(self.circuit, inputs, taus=self.taus)

    def window(self, seconds: float) -> dict:
        """Proofs back to back from the first proof's start until the first
        proof that ends after ``seconds``."""
        self._sync()
        proofs, ends, cpu = [], [], [time.thread_time()]
        start = time.time_ns()
        while True:
            proof = self._prove(self.pool[len(proofs) % len(self.pool)])
            self._sync()
            proof.input_proof.kzg_setup = None  # the SRS is not part of the proof
            proofs.append(proof)
            ends.append(time.time_ns())
            cpu.append(time.thread_time())
            if ends[-1] - start >= seconds * 1e9:
                break
        self.proofs = proofs
        end = ends[-1]
        return {"start_ns": start, "end_ns": end, "attempted": len(proofs), "units": len(proofs),
                "durations_s": [(b - a) / 1e9 for a, b in zip([start] + ends, ends)],
                "main_cpu_s": [b - a for a, b in zip(cpu, cpu[1:])],
                "metrics": {"prove_s": (end - start) / 1e9 / len(proofs)}}

    def release(self) -> None:
        """Take the proofs to plain values and drop the program's state."""
        self.values = [proof_values(p) for p in self.proofs]
        del self.proofs, self.circuit, self.pool
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Mismatched values of the sampled proofs against the reference, and
        the proofs that had any."""
        rng = streams.generator(self.seed, "check")
        count = min(self.mix["checked_proofs"], len(self.values))
        picks = sorted(rng.choice(len(self.values), size=count, replace=False).tolist())
        masks = draw_circuit(self.config, self.seed)
        taus = draw_taus(self.config, self.seed)
        bad_values, bad_proofs = 0, 0
        for i in picks:
            inputs = draw_inputs(self.config, self.seed, i % self.mix["pool"])
            want = reference.prove(masks, inputs, taus, self.device)
            n = mismatches(self.values[i], want)
            bad_values += n
            bad_proofs += n > 0
        return {"checked": picks, "failed": bad_proofs,
                "numbers": [("mismatched_values", bad_values, 0)]}


def control(config: dict, mix: dict, seed: int, device) -> list:
    """The control at this configuration's size: the reference with the
    guarantee that the transcript binds every claim broken, in the program's
    place, against the reference. Returns the numbers the check compares."""
    masks = draw_circuit(config, seed)
    inputs = draw_inputs(config, seed, 0)
    taus = draw_taus(config, seed)
    want = reference.prove(masks, inputs, taus, device)
    got = reference.prove(masks, inputs, taus, device, bind_claims=False)
    return [("mismatched_values", mismatches(got, want), 0)]
