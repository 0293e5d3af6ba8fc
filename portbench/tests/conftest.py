"""Fixtures of the benchmark's own tests: a tiny cell that runs on the CPU
through the program's plain route, and the card, decided per test."""

from __future__ import annotations

import copy

import pytest

TINY = {
    "cell": {"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1},
    "config": {"core_sizes": [60, 90, 120], "gencode": 1, "epsilon": 0.01,
               "multi_hits": True, "hmmer3_compat": False,
               "database_seed": 1},
    "traffic": {"batch": [{"length": 400, "count": 4, "planted": 4}],
                "noise": 0.01, "plant_fill": 0.6,
                # every read of every served batch: how many batches a
                # window of 0.01 s serves depends on the machine's speed,
                # and only profile 0's planted reads give a line here
                "check": {"reads": 64, "profiles": 3, "lines": 2}},
    "limits": {"lrt_gap": 0.5, "lines_differing": 0},
    "end_to_end": [{"name": "reads_per_s", "unit": "reads/s"},
                   {"name": "setup_s", "unit": "s"}],
    "per_layer": [{"name": "decode_write_ms", "unit": "ms/batch"},
                  {"name": "dispatch_ms", "unit": "ms/batch"}],
}
# a seed past 32 signed bits, as the driver's are
BIG_SEED = 2**31 + 12345


@pytest.fixture
def tiny():
    return copy.deepcopy(TINY)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"
