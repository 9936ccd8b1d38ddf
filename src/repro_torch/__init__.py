"""PyTorch/CUDA port of the CFL system (``src/repro`` is the JAX
reference). Imports ``torch`` and numpy only — never JAX, never
``repro``. See ROADMAP.md for what is ported.

Importing the port warms torch's vectorised CPU math (``warm_cpu_math``):
the kernels' plain versions, which the CPU runs and the card's kernels are
held to, must give the same bits on their first call as on every later
one."""
import torch

# the transcendental functions of the port's CPU paths, which torch runs
# through MKL's vector math for contiguous float tensors
_CPU_MATH = (torch.exp, torch.expm1, torch.log, torch.log1p, torch.tanh,
             torch.sqrt, torch.rsqrt, torch.sin, torch.cos, torch.erf,
             torch.sigmoid)


def warm_cpu_math():
    """Call each of ``_CPU_MATH`` once on the calling thread, in fp32 and
    fp64, on one element (no intra-op thread is started).

    torch splits such a call over its intra-op threads past 2048 elements.
    In a fresh process under load, the first split ``torch.exp`` has come
    back with relative errors up to ~1e-4 in the part one of the threads
    computed, while every later call agreed with itself to the bit (the
    SSD scan's decay in ``tests/test_torch_ssm.py``: 5 of 250 fresh test
    processes; the flash softmax of the CPU yardstick in
    ``tests/test_torch_kernels_bwd.py``'s card check). Two threads
    entering MKL's vector math for the first time at once is the pattern;
    a first call on one thread before any split call removes it."""
    for dtype in (torch.float32, torch.float64):
        one = torch.full((1,), 0.5, dtype=dtype)
        for fn in _CPU_MATH:
            fn(one)


warm_cpu_math()
