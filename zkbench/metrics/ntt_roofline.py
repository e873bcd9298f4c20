"""The NTT's share of its roofline: the least time of the window's transforms
over the device time they took, in percent.

The least time counts the work a transform needs, whatever kernels implement
it: its butterfly products (those by w^0 = 1 left out), and for the inverse its
n products by n^-1, at a Montgomery product's 32-bit multiply-adds against the
card's integer peak; each element read once and written once against its
memory peak; the larger of the two. The device time is the union of the
window's device records.
"""

from zkbench.harness.peaks import PEAKS, montgomery_product_ops

LAYER = "NTT orchestration and kernels"
MOVES = "ntt_ms"


def least_seconds(log_n: int, words: int, inverse: bool, peaks: dict) -> float:
    n = 1 << log_n
    products = (n // 2) * log_n - (n - 1) + (n if inverse else 0)
    ops = products * montgomery_product_ops(words)
    nbytes = 2 * n * 4 * words
    return max(ops / peaks["int32_mad_per_s"], nbytes / peaks["bytes_per_s"])


def read(reading):
    peaks = PEAKS.get(reading.device_name)
    if not (peaks and reading.resolved and reading.events):
        return None
    log_n, words = reading.config["log_n"], reading.config["words"]
    pairs = reading.units // 2
    least = pairs * (least_seconds(log_n, words, False, peaks)
                     + least_seconds(log_n, words, True, peaks))
    return 100.0 * least / (reading.busy_ns() / 1e9)
