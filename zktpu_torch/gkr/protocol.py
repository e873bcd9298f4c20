"""GKR prover/verifier with a multilinear-KZG input commitment.

The counterpart of ``zktpu/gkr/protocol.py`` (capability parity with the
reference's gkr/src/gkr_protocol.rs):

  * ``prove`` (:31-126) is ``prove_layers`` followed by the input proof: the
    input layer is committed and opened at (r_b, r_c) with multilinear KZG
    (:92-118, ``pcs/kzg.py``).
  * ``verify`` (:128-227) is ``verify_layers`` on the proof's two opened
    evaluations followed by the pairing checks of both openings.
  * ``prove_layers`` (the body of ``prove``, :31-91): evaluate the circuit,
    absorb the output layer, then walk layers output -> input; layer 0 uses the
    f(b,c) polynomial f = add_i(r,b,c)*(w(b)+w(c)) + mul_i(r,b,c)*(w(b)*w(c))
    (:243-263), later layers the alpha/beta-folded variant (:265-292); each
    layer runs the composed-poly sumcheck. It ends where the input layer's two
    evaluations w(r_b), w(r_c) are claimed.
  * ``verify_layers`` (the body of ``verify``, :128-227): re-derives every
    challenge from the transcript, checks each sumcheck, and recomputes the
    layer identity via the wiring predicates (:294-341). It takes the input
    layer's two evaluations from its caller.

The verifier walks the layers before it pairs: the same verdict as the
reference's order (openings inside the last layer's step), and a proof whose
layers fail is refused without the host's pairings.

Field: BLS12-381 Fr. Transcript bytes match the reference exactly; all O(2^n)
steps (circuit evaluation, wiring tables, sumcheck rounds, SRS, MSMs) run on the
device of the circuit's field context; the verifier's pairings run on the host.

Under an active mesh (``prove(mesh=...)``, or ``parallel.context.use_mesh``
around ``prove_layers``) each lazy layer sumcheck whose w table the mesh's slots
divide runs sharded (``parallel.mesh.gkr_sumcheck_lazy_sharded``), and the KZG
MSMs shard where ``pcs/kzg.py`` says; the proof bytes are the single device's.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

import torch

from ..field import kernels as fk
from ..field.spec import BLS12_381_FR
from ..parallel import context as pctx
from ..parallel import mesh as pm
from ..pcs.kzg import KZG, random_taus
from ..poly.composed import ProductPoly, SumPoly
from ..poly.multilinear import MultilinearPoly
from ..sumcheck import protocol as sumcheck
from ..transcript import Transcript
from . import lazy as lazy_mod
from .circuit import ADD, MUL, Circuit, Layer
from .fused_lazy import gkr_prove_lazy_fused

FR = BLS12_381_FR


@dataclasses.dataclass
class KzgProof:
    """Reference ``KzgProof`` (:16-21)."""

    kzg_setup: KZG
    commitment: object
    proof: list  # [proof_at_rb, proof_at_rc], each a list of G1 points
    opened_evals: list  # [w(r_b), w(r_c)]


@dataclasses.dataclass
class GkrProof:
    """Reference ``GkrProof`` (:24-29). ``input_proof`` is the ``KzgProof`` of
    the input layer at (r_b, r_c); ``prove_layers`` leaves it ``None``."""

    output_poly: MultilinearPoly
    proof_polynomials: list  # per layer: list[UnivariatePoly]
    claimed_evaluations: list  # per non-final layer: (o_1, o_2)
    input_proof: KzgProof | None = None


@dataclasses.dataclass
class LayersProof:
    """What ``prove_layers`` returns: the proof short of its input proof, the
    point pair the input layer is claimed at, and the two claimed evaluations
    ``(w(r_b), w(r_c))`` that an input proof has to open."""

    proof: GkrProof
    r_b: list[int]
    r_c: list[int]
    input_evals: tuple[int, int]


@dataclasses.dataclass
class LayersVerifyResult:
    """Whether every layer held, and the point pair at which the input layer's
    evaluations were used (the openings to check)."""

    verified: bool
    r_b: list[int]
    r_c: list[int]


def _encode(ctx, value: int):
    return fk.to_mont(ctx, ctx.to_device(ctx.pack(value % FR.modulus)))


def _initiate_protocol(transcript: Transcript, output_poly: MultilinearPoly):
    """Absorb w_0, squeeze r, evaluate m_0 (reference :229-241)."""
    transcript.append(output_poly.to_transcript_bytes())
    random_challenge = transcript.get_random_challenge()
    m_0 = output_poly.evaluate_int([random_challenge])
    transcript.append_field_elements([m_0])
    return m_0, random_challenge


def get_fbc_poly(ctx, random_challenge: int, layer: Layer, w_b: MultilinearPoly,
                 w_c: MultilinearPoly) -> SumPoly:
    """f(b,c) as a SumPoly of two 2-factor products (reference :243-263)."""
    r = _encode(ctx, random_challenge)
    add_i = layer.get_add_mul_i(ctx, ADD).partial_evaluate(0, r)
    mul_i = layer.get_add_mul_i(ctx, MUL).partial_evaluate(0, r)

    summed_w = MultilinearPoly.tensor_add_mul(ctx, w_b, w_c, "add")
    multiplied_w = MultilinearPoly.tensor_add_mul(ctx, w_b, w_c, "mul")

    return SumPoly(ctx, [
        ProductPoly(ctx, [add_i, summed_w]),
        ProductPoly(ctx, [mul_i, multiplied_w]),
    ])


def _fold_both(ctx, poly: MultilinearPoly, r_b: list[int], r_c: list[int],
               alpha: int, beta: int) -> MultilinearPoly:
    """alpha * poly(r_b, .) + beta * poly(r_c, .)."""
    rb = [_encode(ctx, v) for v in r_b]
    rc = [_encode(ctx, v) for v in r_c]
    return (poly.multi_partial_evaluate(rb).scale(_encode(ctx, alpha))
            + poly.multi_partial_evaluate(rc).scale(_encode(ctx, beta)))


def get_folded_fbc_poly(ctx, layer: Layer, w_b: MultilinearPoly,
                        w_c: MultilinearPoly, r_b: list[int], r_c: list[int],
                        alpha: int, beta: int) -> SumPoly:
    """alpha/beta random-linear-combination fold (reference :265-292)."""
    summed_add_i = _fold_both(ctx, layer.get_add_mul_i(ctx, ADD), r_b, r_c, alpha, beta)
    summed_mul_i = _fold_both(ctx, layer.get_add_mul_i(ctx, MUL), r_b, r_c, alpha, beta)
    summed_w = MultilinearPoly.tensor_add_mul(ctx, w_b, w_c, "add")
    multiplied_w = MultilinearPoly.tensor_add_mul(ctx, w_b, w_c, "mul")

    return SumPoly(ctx, [
        ProductPoly(ctx, [summed_add_i, summed_w]),
        ProductPoly(ctx, [summed_mul_i, multiplied_w]),
    ])


def get_verifier_claim(ctx, layer: Layer, init_random_challenge: int,
                       sumcheck_challenges: list[int], o_1: int, o_2: int) -> int:
    """Recompute the layer identity at the challenges (reference :294-314)."""
    all_challenges = [init_random_challenge] + list(sumcheck_challenges)
    a_r = layer.get_add_mul_i(ctx, ADD).evaluate_int(all_challenges)
    m_r = layer.get_add_mul_i(ctx, MUL).evaluate_int(all_challenges)
    p = FR.modulus
    return (a_r * (o_1 + o_2) + m_r * (o_1 * o_2)) % p


def get_folded_verifier_claim(ctx, layer: Layer, current_challenges: list[int],
                              previous_challenges: list[int], o_1: int, o_2: int,
                              alpha: int, beta: int) -> int:
    """Folded layer identity (reference :316-341)."""
    mid = len(previous_challenges) // 2
    prev_rb = previous_challenges[:mid]
    prev_rc = previous_challenges[mid:]
    summed_add_i = _fold_both(ctx, layer.get_add_mul_i(ctx, ADD), prev_rb, prev_rc, alpha, beta)
    summed_mul_i = _fold_both(ctx, layer.get_add_mul_i(ctx, MUL), prev_rb, prev_rc, alpha, beta)

    a_r = summed_add_i.evaluate_int(list(current_challenges))
    m_r = summed_mul_i.evaluate_int(list(current_challenges))
    p = FR.modulus
    return (a_r * (o_1 + o_2) + m_r * (o_1 * o_2)) % p


def _lazy_ok(circuit: Circuit) -> bool:
    """The lazy fbc path covers power-of-two layers with <= 2 output gates
    (always true for well-formed reference circuits); anything else takes the
    dense tensors."""
    sizes_ok = all((l.n_gates & (l.n_gates - 1)) == 0 for l in circuit.layers)
    return sizes_ok and circuit.layers[-1].n_gates <= 2


def _context(circuit: Circuit):
    if circuit.ctx.spec is not FR:
        raise ValueError("GKR runs over BLS12-381 Fr")
    return circuit.ctx


def _stage_marks(ctx):
    """``mark(label)``: with ``ZKTPU_TRACE=1`` in the environment, print the wall
    time since the last mark to stderr (on the card after a synchronise, so that
    a stage is charged its own device work); otherwise nothing."""
    trace = os.environ.get("ZKTPU_TRACE") == "1"
    last = [time.time()]

    def mark(label: str) -> None:
        if trace:
            if ctx.device.type == "cuda":
                torch.cuda.synchronize(ctx.device)
            now = time.time()
            print(f"    [gkr.prove] {label}: {now - last[0]:.2f}s", file=sys.stderr, flush=True)
            last[0] = now

    return mark


def prove_layers(circuit: Circuit, inputs: list[int], lazy: bool | None = None,
                 fused: bool | None = None) -> LayersProof:
    """Every layer's sumcheck of a GKR proof over BLS12-381 Fr (reference
    :31-91), on the device of ``circuit.ctx``.

    ``lazy``: use the O(|w|) phase-table sumcheck (``gkr/lazy.py``) instead of
    the reference-shaped dense tensors; proof bytes are identical. Auto-selected
    when None. ``fused``: run each lazy phase with the Fiat-Shamir sponge on the
    device (``gkr/fused_lazy.py``); defaults to True whenever the lazy path is
    active. With ``ZKTPU_TRACE=1`` in the environment the stages' wall times go
    to stderr. Under ``parallel.context.use_mesh`` each lazy layer whose w table
    the mesh's slots divide runs ``gkr_sumcheck_lazy_sharded``; the proof is the
    same."""
    return _walk_layers(circuit, inputs, lazy, fused, _stage_marks(circuit.ctx))[0]


def _walk_layers(circuit: Circuit, inputs: list[int], lazy, fused, mark):
    """The layer walk: (LayersProof, the input polynomial)."""
    ctx = _context(circuit)
    transcript = Transcript(FR)
    if lazy is None:
        lazy = _lazy_ok(circuit)
    if fused is None:
        fused = lazy

    input_poly = MultilinearPoly.from_ints(ctx, inputs)
    mark("inputs upload")
    circuit_evaluations = circuit.evaluate(input_poly)
    mark("circuit evaluate")

    w_0 = circuit_evaluations[-1]
    if w_0.table.shape[0] == 1:  # pad single output to a 1-var MLE (:36-38)
        w_0 = MultilinearPoly(ctx, torch.cat([w_0.table, torch.zeros_like(w_0.table)]))
    output_poly = w_0

    claimed_sum, random_challenge = _initiate_protocol(transcript, output_poly)

    num_layers = circuit.num_layers
    proof_polys = []
    claimed_evaluations = []
    current_rb: list[int] = []
    current_rc: list[int] = []
    alpha = beta = 0
    o_1 = o_2 = 0

    evals_rev = list(reversed(circuit_evaluations))
    layers_rev = list(reversed(circuit.layers))

    for idx, layer in enumerate(layers_rev):
        w_i = input_poly if idx == num_layers - 1 else evals_rev[idx + 1]

        if lazy:
            if idx == 0:
                fbc_poly = lazy_mod.lazy_fbc(ctx, random_challenge, layer, w_i)
            else:
                fbc_poly = lazy_mod.lazy_folded_fbc(
                    ctx, layer, w_i, current_rb, current_rc, alpha, beta
                )
            mesh = pctx.current_mesh()
            if mesh is not None and pctx.shardable(fbc_poly.w_table.shape[0], mesh, min_rows=1):
                sc_proof = pm.gkr_sumcheck_lazy_sharded(claimed_sum, fbc_poly, transcript, mesh)
            elif fused:
                sc_proof = gkr_prove_lazy_fused(claimed_sum, fbc_poly, transcript)
            else:
                sc_proof = lazy_mod.gkr_prove_lazy(claimed_sum, fbc_poly, transcript)
        else:
            if idx == 0:
                fbc_poly = get_fbc_poly(ctx, random_challenge, layer, w_i, w_i)
            else:
                fbc_poly = get_folded_fbc_poly(
                    ctx, layer, w_i, w_i, current_rb, current_rc, alpha, beta
                )
            sc_proof = sumcheck.gkr_prove(claimed_sum, fbc_poly, transcript)
        proof_polys.append(sc_proof.proof_polynomials)

        mid = len(sc_proof.random_challenges) // 2
        current_rb = sc_proof.random_challenges[:mid]
        current_rc = sc_proof.random_challenges[mid:]

        mark(f"layer {idx} sumcheck ({w_i.table.shape[0]} w-entries)")
        o_1 = w_i.evaluate_int(current_rb)
        o_2 = w_i.evaluate_int(current_rc)
        mark(f"layer {idx} o1/o2 evals")

        if idx < num_layers - 1:
            transcript.append_field_elements([o_1])
            alpha = transcript.get_random_challenge()
            transcript.append_field_elements([o_2])
            beta = transcript.get_random_challenge()
            claimed_sum = (alpha * o_1 + beta * o_2) % FR.modulus
            claimed_evaluations.append((o_1, o_2))

    layers = LayersProof(
        GkrProof(output_poly, proof_polys, claimed_evaluations),
        current_rb, current_rc, (o_1, o_2),
    )
    return layers, input_poly


def prove(circuit: Circuit, inputs: list[int], taus: list[int] | None = None,
          lazy: bool | None = None, fused: bool | None = None, mesh=None) -> GkrProof:
    """Full GKR proof over BLS12-381 Fr (reference :31-126): the layer walk
    (``prove_layers``; ``lazy`` and ``fused`` as there), then the KZG commitment
    to the input layer and its openings at r_b and r_c, on the device of
    ``circuit.ctx``. ``taus``: the trusted setup's secrets, from fresh entropy
    when None (reference :92-103). ``mesh``: a ``parallel.mesh.Mesh``, active
    for the whole proof (``use_mesh``): the lazy layer sumchecks run sharded
    over its slots, and the KZG commitment and quotient MSMs where each slot
    gets ``MIN_ROWS_PER_DEVICE`` points; the proof is the single device's."""
    if mesh is not None:
        with pctx.use_mesh(mesh):
            return prove(circuit, inputs, taus=taus, lazy=lazy, fused=fused)
    mark = _stage_marks(circuit.ctx)
    layers, input_poly = _walk_layers(circuit, inputs, lazy, fused, mark)

    if taus is None:
        taus = random_taus(input_poly.num_vars)
    kzg_instance = KZG.for_poly(input_poly, taus)
    mark("KZG setup (SRS comb + g2 taus)")
    w_b_eval = kzg_instance.open(layers.r_b, input_poly)
    w_c_eval = kzg_instance.open(layers.r_c, input_poly)
    mark("KZG opens")
    commitment, w_b_proof, w_c_proof = kzg_instance.commit_with_proof_pair(
        (w_b_eval, layers.r_b), (w_c_eval, layers.r_c), input_poly
    )
    mark("KZG commit + proofs (batched MSMs)")

    proof = layers.proof
    proof.input_proof = KzgProof(
        kzg_setup=kzg_instance,
        commitment=commitment,
        proof=[w_b_proof, w_c_proof],
        opened_evals=[w_b_eval, w_c_eval],
    )
    return proof


def verify_layers(proof: GkrProof, circuit: Circuit, input_evals,
                  lazy: bool | None = None) -> LayersVerifyResult:
    """Every layer's check of the reference's ``verify`` (:128-227).
    ``input_evals`` are the input layer's claimed ``(w(r_b), w(r_c))``; whoever
    calls this has to check them against the input at the returned ``r_b``,
    ``r_c``. ``lazy`` selects the analytic wiring-predicate evaluation (same
    field values as the dense tables; auto when None)."""
    ctx = _context(circuit)
    transcript = Transcript(FR)
    if lazy is None:
        lazy = _lazy_ok(circuit)
    refused = LayersVerifyResult(False, [], [])

    current_claim, init_random_challenge = _initiate_protocol(
        transcript, proof.output_poly
    )

    alpha = beta = 0
    prev_challenges: list[int] = []
    challenges: list[int] = []
    layers_rev = list(reversed(circuit.layers))
    num_layers = len(layers_rev)

    for i, layer in enumerate(layers_rev):
        sc_verify = sumcheck.gkr_verify(
            proof.proof_polynomials[i], current_claim, transcript, FR
        )
        if not sc_verify.verified:
            return refused

        challenges = sc_verify.random_challenges

        if i == num_layers - 1:
            o_1, o_2 = input_evals
        else:
            o_1, o_2 = proof.claimed_evaluations[i]

        if i == 0:
            claim_fn = (lazy_mod.verifier_claim_lazy if lazy
                        else get_verifier_claim)
            expected_claim = claim_fn(
                ctx, layer, init_random_challenge, challenges, o_1, o_2
            )
        else:
            claim_fn = (lazy_mod.folded_verifier_claim_lazy if lazy
                        else get_folded_verifier_claim)
            expected_claim = claim_fn(
                ctx, layer, challenges, prev_challenges, o_1, o_2, alpha, beta
            )

        if expected_claim != sc_verify.final_claimed_sum % FR.modulus:
            return refused

        prev_challenges = challenges

        transcript.append_field_elements([o_1])
        alpha = transcript.get_random_challenge()
        transcript.append_field_elements([o_2])
        beta = transcript.get_random_challenge()
        current_claim = (alpha * o_1 + beta * o_2) % FR.modulus

    mid = len(challenges) // 2
    return LayersVerifyResult(True, challenges[:mid], challenges[mid:])


def verify(proof: GkrProof, circuit: Circuit, lazy: bool | None = None) -> bool:
    """Reference :128-227: every layer's check (``verify_layers``) on the input
    proof's opened evaluations, then the KZG pairing check of both openings at
    the walk's (r_b, r_c). ``lazy`` as in ``verify_layers``."""
    kzg = proof.input_proof
    if kzg is None:
        raise ValueError("the proof carries no input proof (it came from prove_layers)")
    o_1, o_2 = kzg.opened_evals
    walked = verify_layers(proof, circuit, (o_1, o_2), lazy=lazy)
    if not walked.verified:
        return False
    g2_taus = kzg.kzg_setup.g2_taus
    return (KZG.verify(kzg.commitment, o_1, kzg.proof[0], walked.r_b, g2_taus)
            and KZG.verify(kzg.commitment, o_2, kzg.proof[1], walked.r_c, g2_taus))
