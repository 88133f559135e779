"""Test settings of the benchmark's own tests (``benchmark/tests``): the
``card`` marker for the tests that need a CUDA card. Those tests decide
inside themselves whether a card is present and skip on a machine
without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none "
        "(run with: python3 -m pytest benchmark/tests -m card)")
