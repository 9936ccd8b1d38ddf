"""PyTorch/CUDA port of the CFL system (``src/repro`` is the JAX
reference). Imports ``torch`` and numpy only — never JAX, never
``repro``. See ROADMAP.md for what is ported."""
