"""Host ms of the session's forward (span ``stylize`` › ``forward``: layout,
generator, gather), the median over the timed window's calls."""

from benchmark.metrics import _window


def read(records):
    return _window.span_ms(records, "stylize", "stylize", "forward")
