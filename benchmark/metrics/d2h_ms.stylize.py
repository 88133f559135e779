"""Host ms of the session's copy out (span ``stylize`` › ``d2h``: to uint8
and to the host, which waits for the forward), the median over the timed
window's calls."""

from benchmark.metrics import _window


def read(records):
    return _window.span_ms(records, "stylize", "stylize", "d2h")
