"""Pytest settings of the whole checkout: the marker of tests that need a
CUDA card.  A test so marked takes the ``card`` fixture of its file,
which skips it, with the reason, where no card is present; on the card
machine run them with ``python -m pytest --noconftest -m cuda <file>``
(``tests/conftest.py`` imports JAX, which that machine lacks)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (a hand-written kernel, which "
        "has no CPU mode); skipped without one")
