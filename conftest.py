"""Registers the marker of tests that need a CUDA device (the PyTorch
port's kernel tests). Such a test skips itself when no card is present;
run them on a GPU host with ``python -m pytest -m cuda tests/``."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)"
    )
