"""The sequential trainer (``batched_rounds=False``) on the transformer zoo
against the JAX reference and against the port's batched engine, for a
dense and a MoE parent here and an SSM parent in
``tests/test_torch_zoo_sequential_ssm.py`` (reduced: 3 layers, d_model
64; the attention parents with 4 query / 2 KV heads so that the head
prefix is elastic), 2 clients of 16 Markov sequences of 16 tokens, batch
8, each client's submodel cutting depth and a width:

* one round of ``SequentialFamilyTrainer.run_fl_round`` (the extracted
  submodels' plain forward, the padded updates, the paper's rule on the
  dense parent, the coverage rule on the others) against the reference's
  ``SequentialFamilyTrainer`` on its parameters, bridged: new parameters
  within 1e-5 of the round's movement, accuracies within 1e-3, the same
  step counts;
* the same round against the port's batched dense round in fp64: within
  1e-5 of the round's movement. On the MoE parent every client keeps half
  the routed experts and the batched family sizes its capacity by them
  (``MoEConfig.capacity_experts``): the extracted submodel sizes its
  capacity by its own expert count, the masked parent by the parent's
  unless told, so only then do the two compute the same round.

(The sequential trainer behind ``CFLSession``:
``tests/test_torch_zoo_session_seq.py``.)
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.data.synth import make_lm_dataset
from repro.fl import engine as ref_engine
from repro.models import transformer as RT
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.core.elastic import TransformerElasticFamily
from repro_torch.core.submodel import TransformerSubSpec
from repro_torch.fl.engine import BatchedRoundEngine, SequentialFamilyTrainer
from zoo_session_support import numpy_tree, ratio, ref_spec

torch.set_num_threads(2)
TOL = 1e-5
HEADS = dict(n_heads=4, n_kv_heads=2, head_dim=16)
NAMES = {"dense": "granite-3-8b", "moe": "granite-moe-1b-a400m",
         "ssm": "mamba2-2.7b"}
# (kept layers, the family's width fraction, attn_head_frac) per client
SPECS = {"dense": [((0, 2), 0.5, 0.5), ((1,), 0.25, 1.0)],
         "moe": [((1, 2), 0.5, 0.5), ((0,), 0.5, 1.0)],
         "ssm": [((0, 2), 0.5, 1.0), ((2,), 0.25, 1.0)]}
KW = dict(batch_size=8, epochs=1, seeds=[5, 6])


def configs(kind):
    port = reduced(ARCHS[NAMES[kind]], n_layers=3, d_model=64)
    ref = ref_reduced(REF_ARCHS[NAMES[kind]], n_layers=3, d_model=64)
    if kind != "ssm":
        port, ref = (dataclasses.replace(c, **HEADS) for c in (port, ref))
    return port, ref


def specs(kind, width=None):
    dim = {"dense": "ff_frac", "moe": "expert_frac",
           "ssm": "ssm_head_frac"}[kind]
    return [TransformerSubSpec((layers,), attn_head_frac=ah,
                               **{dim: width or w})
            for layers, w, ah in SPECS[kind]]


def make_setting(kind):
    """The family's configs, the reference's initial parameters and the
    clients' train / test data."""
    cfg, ref_cfg = configs(kind)
    init = numpy_tree(RT.init_params(jax.random.PRNGKey(2), ref_cfg))
    train = [make_lm_dataset(16, 16, cfg.vocab_size, seed=k, chain_seed=9)
             for k in range(2)]
    test = [make_lm_dataset(8, 16, cfg.vocab_size, seed=20 + k,
                            chain_seed=9) for k in range(2)]
    return kind, cfg, ref_cfg, init, train, test


@pytest.fixture(scope="module", params=["dense", "moe"])
def setting(request):
    return make_setting(request.param)


def test_sequential_round_matches_reference(setting):
    kind, cfg, ref_cfg, init, train, test = setting
    sizes = [len(d["y"]) for d in train]
    cov = kind != "dense"
    want, want_accs, want_n = ref_engine.SequentialFamilyTrainer(
        ref_cfg, lr=0.05, momentum=0.9).run_fl_round(
        init, [ref_spec(s) for s in specs(kind)], train, test, sizes,
        coverage_norm=cov, **KW)
    got, accs, n = SequentialFamilyTrainer(
        TransformerElasticFamily(cfg), lr=0.05, momentum=0.9).run_fl_round(
        params_from_numpy(init, device="cpu"), specs(kind), train, test,
        sizes, coverage_norm=cov, **KW)
    np.testing.assert_array_equal(n, want_n)
    assert ratio(params_to_numpy(got), numpy_tree(want), init) <= TOL
    np.testing.assert_allclose(accs, want_accs, atol=1e-3, rtol=0)


def test_sequential_round_matches_batched_fp64(setting):
    kind, cfg, _, init, train, test = setting
    width = None
    if kind == "moe":          # every client 2 of 4 experts, capacity by 2
        width = 0.5
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_experts=2))
    fam = TransformerElasticFamily(cfg)
    p0 = params_from_numpy(jax.tree.map(lambda a: a.astype(np.float64),
                                        init), device="cpu")
    sizes = [len(d["y"]) for d in train]
    seq, accs_s, n_s = SequentialFamilyTrainer(
        fam, lr=0.05, momentum=0.9).run_fl_round(
        p0, specs(kind, width), train, test, sizes, **KW)
    bat, accs_b, n_b = BatchedRoundEngine(
        fam, lr=0.05, momentum=0.9, backend=None,
        device="cpu").run_fl_round(p0, specs(kind, width), train, test,
                                   sizes, **KW)
    np.testing.assert_array_equal(n_s, n_b)
    assert ratio(params_to_numpy(seq), params_to_numpy(bat),
                 params_to_numpy(p0)) <= TOL
    np.testing.assert_allclose(accs_s, accs_b, atol=1e-3, rtol=0)
