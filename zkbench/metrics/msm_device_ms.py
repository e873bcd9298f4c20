"""The MSM layer's device time: the profiler's device milliseconds, a proof, of
the kernels below that run inside the KZG spans. The port's own: both kernels
of ``run_scan``, ``compact_add``, ``horner``, and the point kernels under the
SRS comb; PyTorch's: the sorts and the gathers of the MSMs' presort."""

import re

LAYER = "KZG and MSMs"
MOVES = "prove_s"
SPANS = {
    "KZG.for_poly": "zktpu_torch.pcs.kzg:KZG.for_poly",
    "KZG.open": "zktpu_torch.pcs.kzg:KZG.open",
    "KZG.commit_with_proof_pair": "zktpu_torch.pcs.kzg:KZG.commit_with_proof_pair",
}
PORT_KERNELS = ("run_scan_tiles", "run_scan_fill", "compact_add", "horner", "point_add",
                "point_double")
TORCH_NEEDLES = ("sort", "Sort", "gather", "Gather", "index", "Index")

_PORT = re.compile(r"\b(" + "|".join(PORT_KERNELS) + r")_kernel\b")


def is_msm_kernel(name: str) -> bool:
    return bool(_PORT.search(name)) or any(n in name for n in TORCH_NEEDLES)


def read(reading):
    if not (reading.resolved and reading.spans.get("KZG.for_poly")):
        return None
    events = [e for e in reading.inside(SPANS) if is_msm_kernel(e[0])]
    if not events:
        return None
    return sum(d for _, _, d in events) / 1e6 / reading.units
