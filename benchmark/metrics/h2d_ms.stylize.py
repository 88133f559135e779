"""Host ms of the session's copy in (span ``stylize`` › ``h2d``: the uint8
batch to the card, normalize, cast), the median over the timed window's
calls."""

from benchmark.metrics import _window


def read(records):
    return _window.span_ms(records, "stylize", "stylize", "h2d")
