"""Registers the marker of tests that need a CUDA device (the PyTorch
port's kernel tests). Such a test skips itself when no card is present;
run them on a GPU host with ``python -m pytest -m cuda tests/``.

It also gives torch's CPU thread pool (OpenMP, MKL) two threads unless
``OMP_NUM_THREADS`` says otherwise. The suite runs in several pytest-xdist
workers at once, and a pool of one thread per core in each worker
oversubscribes the cores: the pool's barriers then wait for descheduled
threads, and the port's tests, made of many small torch operations, slow
down several times (``tests/test_torch_port_contextpred.py`` beside five
busy processes on 8 cores: 182 s with 8 threads, 38 s with two, 55 s
with one). The one comparison known to turn on MKL's summation order,
``tests/test_torch_port_gin_conv.py::test_plain_gradients_match_jax``,
pins torch's thread count itself and passes at any count."""

import os

os.environ.setdefault("OMP_NUM_THREADS", "2")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)"
    )
