"""Device kernels a proof: the profiler's count of kernels in the window, the
port's own and PyTorch's (copies and fills left out), over the proofs."""

LAYER = "CUDA kernels and eager device glue"
MOVES = "prove_s"


def read(reading):
    if not (reading.resolved):
        return None
    kernels = reading.kernels()
    return len(kernels) / reading.units if kernels else None
