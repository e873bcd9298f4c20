"""Generator of NTT pairs: each resident table's forward transform, then the
inverse of that output, the tables in turn, issued back to back without a host
wait; the window ends with a synchronize after the last pair.

Mix parameters: ``tables`` (resident tables), ``warmup_pairs``,
``sample_within`` (the checked pair is drawn from the seed among the window's
first so many, and the last pair is checked too).

Configuration: ``log_n``, ``words``, ``field`` (``modulus``, ``generator``,
``two_adicity``).
"""

from __future__ import annotations

import gc
import os
import time

import torch

from ..harness import streams
from ..reference import ntt as reference
from ..reference.field import PrimeField


def draw_table(config: dict, seed: int, index: int, device) -> torch.Tensor:
    """Canonical words below the modulus: the low words uniform, the top word
    uniform below the modulus's top word. ``(2^log_n, words)`` int32."""
    words = config["words"]
    n = 1 << config["log_n"]
    modulus = int(config["field"]["modulus"], 0)
    top = modulus >> (32 * (words - 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(streams.torch_seed(seed, "table", index))
    w = torch.randint(0, 1 << 32, (n, words), dtype=torch.int64, generator=gen, device=device)
    w[:, -1] = torch.randint(0, top, (n,), dtype=torch.int64, generator=gen, device=device)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


class Generator:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"

    def _sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        from zktpu_torch import _build
        from zktpu_torch.field import torch_backend as fb
        from zktpu_torch.field.spec import BN254_FR

        t0 = time.time()
        if self.on_card:
            stems = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu"))
            _build.build_cuda_libraries(stems)
        if int(self.config["field"]["modulus"], 0) != BN254_FR.modulus:
            raise ValueError("the NTT generator runs BN254 Fr")
        t1 = time.time()
        self.ctx = fb.get_ctx(BN254_FR, self.device)
        self.tables = [draw_table(self.config, self.seed, t, self.device)
                       for t in range(self.mix["tables"])]
        self._sync()
        t2 = time.time()
        for p in range(self.mix["warmup_pairs"]):
            self._pair(self.tables[p % len(self.tables)])
        self._sync()
        self.setup_stages = [("libraries", t1 - t0), ("inputs", t2 - t1),
                             ("warm-up", time.time() - t2)]

    def _pair(self, table):
        from zktpu_torch.ntt import ntt

        forward = ntt.ntt(self.ctx, table)
        return forward, ntt.ntt(self.ctx, forward, inverse=True)

    def window(self, seconds: float) -> dict:
        sample = int(streams.generator(self.seed, "sample").integers(self.mix["sample_within"]))
        kept = {}
        self._sync()
        pairs = 0
        start = time.time_ns()
        while True:
            t = pairs % len(self.tables)
            forward, inverse = self._pair(self.tables[t])
            if pairs == sample:
                kept[pairs] = (t, forward, inverse)
            pairs += 1
            if time.time_ns() - start >= seconds * 1e9:
                break
        self._sync()
        end = time.time_ns()
        kept[pairs - 1] = (t, forward, inverse)
        self.kept = kept
        return {"start_ns": start, "end_ns": end, "attempted": 2 * pairs, "units": 2 * pairs,
                "metrics": {"ntt_ms": (end - start) / 1e6 / (2 * pairs)}}

    def release(self) -> None:
        del self.tables, self.ctx
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Mismatched words of the kept pairs' transforms against the
        reference's, and the transforms that had any."""
        field = self.config["field"]
        F = PrimeField(int(field["modulus"], 0), self.device)
        bad_values, bad_transforms = 0, 0
        for index, (t, forward, inverse) in sorted(self.kept.items()):
            table = draw_table(self.config, self.seed, t, self.device)
            want_f = reference.ntt_words(F, table, field["generator"], field["two_adicity"])
            want_i = reference.ntt_words(F, want_f, field["generator"], field["two_adicity"],
                                         inverse=True)
            for got, want in ((forward, want_f), (inverse, want_i)):
                n = int((got != want).any(dim=1).sum())
                bad_values += n
                bad_transforms += n > 0
        checked = sorted(self.kept)
        self.kept = None
        return {"checked": checked, "failed": bad_transforms,
                "numbers": [("mismatched_values", bad_values, 0)]}


def control(config: dict, mix: dict, seed: int, device) -> list:
    """The control at this configuration's size: the reference with the
    guarantee of canonical output words broken (the last butterflies and the
    inverse's scaling left below 2p, not reduced), in the program's place,
    against the reference, on one pair of the first table."""
    field = config["field"]
    F = PrimeField(int(field["modulus"], 0), device)
    table = draw_table(config, seed, 0, device)
    args = (field["generator"], field["two_adicity"])
    bad = 0
    want_f = reference.ntt_words(F, table, *args)
    got_f = reference.ntt_words(F, table, *args, reduce_last=False)
    want_i = reference.ntt_words(F, want_f, *args, inverse=True)
    got_i = reference.ntt_words(F, got_f, *args, inverse=True, reduce_last=False)
    for got, want in ((got_f, want_f), (got_i, want_i)):
        bad += int((got != want).any(dim=1).sum())
    return [("mismatched_values", bad, 0)]
