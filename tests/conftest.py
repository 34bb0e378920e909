"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The normal suite runs on ``xla_force_host_platform_device_count=8`` CPU
devices on any host, per SURVEY.md §4's test strategy (the reference has no
tests at all — this suite is built from scratch against the golden model in
kmer_counter.golden).  Tests marked ``gpu`` need the card: they skip here
(the ``gpu`` fixtures decide) and run on a GPU host with ``pytest -m gpu``,
which leaves JAX on its default platform.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


def pytest_configure(config):
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test on a host without one."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(
            f"needs a GPU (JAX runs on {device.platform}); "
            "run `pytest -m gpu` on the card"
        )
    return device


@pytest.fixture
def gpus4(gpu):
    """Four GPU devices; skips the test on a host with fewer."""
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip(f"needs 4 GPUs, found {len(devices)}")
    return devices[:4]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_reads(rng, n_reads, line_length, invalid_frac=0.0, alphabet="ACGT"):
    """Dense [R, L] uint8 ASCII read matrix with optional invalid bases."""
    chars = np.frombuffer("".join(alphabet).encode(), dtype=np.uint8)
    reads = chars[rng.integers(0, len(chars), size=(n_reads, line_length))]
    if invalid_frac > 0:
        mask = rng.random((n_reads, line_length)) < invalid_frac
        reads = np.where(mask, np.uint8(ord("N")), reads)
    return reads


@pytest.fixture
def make_reads(rng):
    def _make(n_reads, line_length, invalid_frac=0.0):
        return random_reads(rng, n_reads, line_length, invalid_frac)

    return _make
