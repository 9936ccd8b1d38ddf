"""One batched CFL round of each of the zoo's last three decoder parents
(``tests/a11_support.py``: deepseek-v2-lite, gemma2, zamba2 reduced) on
the port's ``BatchedRoundEngine``, both paths — the kernels' plain
versions (``backend="auto"`` on the CPU) and the dense masked path —
against the reference's engine on its parameters, bridged: 3 clients whose
specs cut each elastic dim and the depth (``a11_support.cohort_specs``),
Markov sequences of 16 tokens (32 on gemma2 and zamba2, so that the local
window and the shared block's window bind), 2 local epochs, coverage
aggregation. New parameters within 1e-5 of the round's movement, the same
step counts and eval tokens right.

zamba2 trains at lr 0.01: from 0.02 up, the reference's own engine
returns NaN parameters on this cohort — client 0 (the full spec) alone
does it — while the port's stay finite. Its gradients at the initial
parameters and along plain momentum SGD on the same masked loss are
finite; where its engine's trajectory turns NaN was not traced.
"""
import numpy as np
import pytest
import torch

import a11_support as A
from repro.data import synth as ref_synth
from repro.fl import engine as ref_engine
from repro_torch.checkpoint.bridge import params_to_numpy
from repro_torch.fl import engine
from zoo_session_support import ratio

torch.set_num_threads(2)
SEQ = {"deepseek-v2-lite-16b": 16, "gemma2-9b": 32, "zamba2-1.2b": 32}
LR = {"deepseek-v2-lite-16b": 0.1, "gemma2-9b": 0.1, "zamba2-1.2b": 0.01}


def _setup(name):
    cfg, ref_cfg = A.configs(name)
    params = A.ref_params(ref_cfg, 0)
    S = SEQ[name]
    sizes = [8, 6, 5]
    train = [ref_synth.make_lm_dataset(n, S, 6, seed=k, chain_seed=100 + k)
             for k, n in enumerate(sizes)]
    test = [ref_synth.make_lm_dataset(4, S, 6, seed=50 + k,
                                      chain_seed=100 + k) for k in range(3)]
    kw = dict(batch_size=4, epochs=2, seeds=[1, 2, 3])
    return cfg, ref_cfg, params, sizes, train, test, kw


@pytest.fixture(scope="module", params=A.PARENTS)
def reference_round(request):
    name = request.param
    _, ref_cfg, params, sizes, train, test, kw = _setup(name)
    eng = ref_engine.BatchedRoundEngine(ref_cfg, lr=LR[name], momentum=0.9)
    new, accs, n_steps = eng.run_fl_round(
        params, [A.ref_spec(s) for s in A.cohort_specs(name)], train, test,
        sizes, coverage_norm=True, **kw)
    return name, A.np_tree(new), accs, np.asarray(n_steps)


@pytest.mark.parametrize("backend", ["auto", None])
def test_run_fl_round_matches_reference(reference_round, backend):
    name, want_new, want_accs, want_steps = reference_round
    cfg, _, params, sizes, train, test, kw = _setup(name)
    eng = engine.BatchedRoundEngine(cfg, lr=LR[name], momentum=0.9,
                                    backend=backend, device="cpu")
    new, accs, n_steps = eng.run_fl_round(
        A.bridged(params), A.cohort_specs(name), train, test, sizes,
        coverage_norm=True, **kw)
    np.testing.assert_array_equal(n_steps, want_steps)
    n_tok = 4 * (SEQ[name] - 1)
    assert [round(a * n_tok) for a in accs] == \
        [round(a * n_tok) for a in want_accs]
    assert ratio(params_to_numpy(new), want_new, params) <= A.TOL
