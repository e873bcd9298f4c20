"""The device's idle share of the traced window, in percent
(``devtrace.idle_pct``)."""

from zkbench.harness.devtrace import idle_pct as read  # noqa: F401

LAYER = "device"
MOVES = "ntt_ms"
