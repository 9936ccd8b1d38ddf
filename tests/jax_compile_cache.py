"""A persistent JAX compilation cache for the test processes of one
checkout, under ``build/jax_compile_cache`` (git-ignored).

The port's parity tests run the reference's programs on the CPU, and many
files compile the same ones (the quickstart CNN's engine, the reduced zoo
parents' steps); the reference's own test files compile theirs again and
again too. With this module imported, every program is compiled once per
checkout and loaded from the cache by every later compile of the same
program, in any test process (xdist workers included): the executables are
the ones a fresh compile gives, so no result changes. A cache directory
given in the environment (``JAX_COMPILATION_CACHE_DIR``) is left as it is.

Importing it from any test module turns it on for the whole pytest run,
since collection imports every test module before a test runs.
"""
import os

import jax

CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "jax_compile_cache")

if not jax.config.jax_compilation_cache_dir:
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # every program, not only those that take a second or more to compile
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
