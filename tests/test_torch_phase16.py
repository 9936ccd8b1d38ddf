"""Phase 16 of ``chip_smoke.py`` alone on the card: partial
participation under the three selection policies, async at the sync
operating point (bit-equal to sync), buffered async with faults (the
event columns of the kernel and the dense path identical, the buffered
step against fp64), FedAvg under the fairness policy, and a granite-3-8b
round of 2 of 4 clients — every launch count and hold of the phase
(``chip_smoke.phase_selection``). Skips without a card; imports no JAX.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_phase16.py
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_cuda_phase_16_selection_async_and_faults():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels.backend import resolve_device
    launches, stats = chip_smoke.phase_selection(resolve_device("cuda"))
    assert stats["async_sync_point_bit_equal"]
    assert stats["fedavg_async_bit_equal"]
    assert stats["buffered"]["identical"]
    assert all(n["elastic_dense"] > 0 for n in launches.values())
