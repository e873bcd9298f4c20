"""Generator of GKR layer walks: ``gkr_prove``'s caller, circuit and input
pool, each proof ``gkr.protocol.prove_layers`` alone, with no input
commitment: GKR for delegated computation, where the verifier holds the inputs.

The proof's values are the output layer, the round polynomials, the claimed
pairs and the walk's ``input_evals`` (``opened``), held against the reference's
values for the same keys. Mix and configuration parameters as ``gkr_prove``'s
(its ``tau_*`` are read only by the reference, whose KZG values are dropped).
"""

from __future__ import annotations

import gc

import torch

from ..harness import closed_loop, streams
from ..harness.compare import mismatches
from ..reference import gkr as reference
from . import gkr_prove
from .gkr_prove import draw_circuit, draw_inputs, draw_taus

#: the reference's values of the input commitment, which a walk does not make
KZG_KEYS = ("commitment", "quotients")


def walk_values(layers) -> dict:
    """A ``LayersProof`` as plain Python values, named as the reference names
    them."""
    proof = layers.proof
    return {
        "output": proof.output_poly.to_ints(),
        "round_polys": [[list(p.coefficients) for p in layer] for layer in proof.proof_polynomials],
        "claimed": [tuple(c) for c in proof.claimed_evaluations],
        "opened": list(layers.input_evals),
    }


def reference_walk(config: dict, seed: int, index: int, device, bind_claims: bool = True) -> dict:
    """The reference's values of the walk of input set ``index``."""
    want = reference.prove(draw_circuit(config, seed), draw_inputs(config, seed, index),
                           draw_taus(config, seed), device, bind_claims=bind_claims)
    return {k: v for k, v in want.items() if k not in KZG_KEYS}


class Generator(gkr_prove.Generator):
    def _prove(self, inputs):
        from zktpu_torch.gkr import protocol

        return protocol.prove_layers(self.circuit, inputs)

    def window(self, seconds: float) -> dict:
        self.proofs, window = closed_loop.window(self._prove, self.pool, seconds, self._sync)
        return window

    def release(self) -> None:
        """Take the walks to plain values and drop the program's state."""
        self.values = [walk_values(p) for p in self.proofs]
        del self.proofs, self.circuit, self.pool
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Mismatched values of the sampled walks against the reference, and
        the walks that had any."""
        rng = streams.generator(self.seed, "check")
        count = min(self.mix["checked_proofs"], len(self.values))
        picks = sorted(rng.choice(len(self.values), size=count, replace=False).tolist())
        bad_values, bad_proofs = 0, 0
        for i in picks:
            want = reference_walk(self.config, self.seed, i % self.mix["pool"], self.device)
            n = mismatches(self.values[i], want)
            bad_values += n
            bad_proofs += n > 0
        return {"checked": picks, "failed": bad_proofs,
                "numbers": [("mismatched_values", bad_values, 0)]}


def control(config: dict, mix: dict, seed: int, device) -> list:
    """The control at this configuration's size: the reference with the
    guarantee that the transcript binds every claim broken (w(r_b), w(r_c)
    left out of it), in the program's place, against the reference."""
    want = reference_walk(config, seed, 0, device)
    got = reference_walk(config, seed, 0, device, bind_claims=False)
    return [("mismatched_values", mismatches(got, want), 0)]
