"""The zoo's extract / pad (``core/submodel.py``) and the transformer
family's sequential surface against the JAX reference, on the reference's
parameters, bridged, for a dense parent here and a MoE and an SSM parent
in ``tests/test_torch_zoo_extract_{moe,ssm}.py`` (reduced: 3
layers, d_model 64; the attention parents with 4 query / 2 KV heads so
that the head prefix is elastic, the dense one with d_ff 100 so that the
8-rounding of d_ff bites).

For specs that cut each elastic dim in turn (d_ff, routed experts, SSD
heads, query heads, depth) and random ones:

* every leaf of ``extract_transformer`` equal to the reference's, and
  ``sub_transformer_config`` equal field by field;
* ``pad_transformer`` of a random delta equal to the reference's, with
  exact zeros off the coverage; the pad of all-ones equal to the broadcast
  of ``coverage_factors`` (the batched engine's coverage);
* ``sub_loss`` / ``sub_metric`` / ``sub_logits`` of the extracted params
  within 1e-5 of the reference's (the cohort forward on a one-client
  stack: cut GQA groups, cut experts with the capacity they imply,
  ``d_inner_override``'s SSD heads).
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.core import submodel as ref_submodel
from repro.core import elastic as ref_elastic
from repro.core.elastic import TransformerElasticFamily as RefFamily
from repro.models import transformer as RT
from repro_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import submodel
from repro_torch.core.elastic import TransformerElasticFamily
from repro_torch.models import transformer as PT
from repro_torch.optim.optimizers import tree_map

torch.set_num_threads(2)
TOL = 1e-5
HEADS = dict(n_heads=4, n_kv_heads=2, head_dim=16)


def configs(kind):
    """(port, reference) reduced configs of one family."""
    name = {"dense": "granite-3-8b", "moe": "granite-moe-1b-a400m",
            "ssm": "mamba2-2.7b"}[kind]
    port = reduced(ARCHS[name], n_layers=3, d_model=64)
    ref = ref_reduced(REF_ARCHS[name], n_layers=3, d_model=64)
    if kind != "ssm":
        extra = dict(HEADS, d_ff=100) if kind == "dense" else HEADS
        port, ref = (dataclasses.replace(c, **extra) for c in (port, ref))
    return port, ref


def ref_spec(s):
    return ref_submodel.TransformerSubSpec(s.layers, s.ff_frac, s.expert_frac,
                                           s.ssm_head_frac, s.attn_head_frac)


def specs(fam, n_random=4, widths=(0.5, 0.25)):
    """The full spec, a dropped layer, each elastic dim cut in turn (to
    each of ``widths``), the minimal spec, and random specs."""
    full = fam.full_spec()
    out = [full, dataclasses.replace(full, layers=((0, 2),))]
    dims = ["ff_frac", "attn_head_frac"] if fam.cfg.moe is None else \
        ["expert_frac", "attn_head_frac"]
    if fam.cfg.ssm is not None:
        dims = ["ssm_head_frac"]
    for dim in dims:
        for w in widths:
            out.append(dataclasses.replace(full, **{dim: w}))
    out.append(fam.minimal_spec())
    rng = random.Random(7)
    out += [fam.random_spec(rng) for _ in range(n_random)]
    return out


def make_parent(kind):
    """(port family, reference family, reference parameters) of ``kind``."""
    cfg, ref_cfg = configs(kind)
    params = jax.tree.map(np.asarray,
                          RT.init_params(jax.random.PRNGKey(3), ref_cfg))
    return (TransformerElasticFamily(cfg, seq_len=8),
            RefFamily(ref_cfg, seq_len=8), params)


# the MoE and SSM parents run the same tests from
# tests/test_torch_zoo_extract_{moe,ssm}.py, so that each file stays
# under a minute
@pytest.fixture(scope="module", params=["dense"])
def parent(request):
    return make_parent(request.param)


def leaves(tree):
    return jax.tree.leaves(params_to_numpy(tree))


def test_extract_and_sub_config_equal_reference(parent):
    fam, ref_fam, params = parent
    port = params_from_numpy(params, device="cpu")
    cut = set()
    for spec in specs(fam):
        got, cfg = fam.extract(port, spec)
        want, ref_cfg = ref_fam.extract(params, ref_spec(spec))
        a, b = leaves(got), jax.tree.leaves(want)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape
            np.testing.assert_array_equal(x, np.asarray(y))
        for f in dataclasses.fields(ref_cfg):
            assert repr(getattr(cfg, f.name)) == repr(getattr(ref_cfg,
                                                              f.name))
        assert cfg == fam.sub_ctx(spec)
        for field, full in (("n_heads", fam.cfg.n_heads),
                            ("d_ff", fam.cfg.d_ff), ("n_layers", 3)):
            if getattr(cfg, field) < full:
                cut.add(field)
        if cfg.moe is not None and cfg.moe.n_experts < fam.cfg.moe.n_experts:
            cut.add("experts")
        if cfg.ssm is not None and cfg.ssm.d_inner_override is not None:
            cut.add("ssd_heads")
    want = {"n_layers", "d_ff"} | (
        {"experts", "n_heads"} if fam.cfg.moe is not None else
        {"ssd_heads"} if fam.cfg.ssm is not None else {"n_heads"})
    if fam.cfg.ssm is not None:
        want.discard("d_ff")
    assert want <= cut


def test_pad_equal_reference_and_coverage(parent):
    fam, ref_fam, params = parent
    port = params_from_numpy(params, device="cpu")
    rng = np.random.default_rng(0)
    shapes = PT.param_shapes(fam.cfg)
    for spec in specs(fam, n_random=2):
        want_sub, _ = ref_fam.extract(params, ref_spec(spec))
        delta = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            want_sub)
        got = fam.pad_delta(params_from_numpy(delta, device="cpu"), port,
                            spec)
        want = ref_fam.pad_delta(delta, params, ref_spec(spec))
        ones = fam.pad_delta(tree_map(torch.ones_like,
                                      fam.extract(port, spec)[0]), port,
                             spec)
        factors = submodel.coverage_factors(fam.cfg, spec, shapes)
        for g, w, o, f in zip(leaves(got), jax.tree.leaves(want),
                              leaves(ones), jax.tree.leaves(factors)):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(o, np.broadcast_to(f, o.shape))
            assert not np.any(g[o == 0])


def test_sub_forward_matches_reference(parent):
    fam, ref_fam, params = parent
    port = params_from_numpy(params, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, fam.cfg.vocab_size, (3, 16)).astype(np.int32)
    valid = np.asarray([1.0, 0.0, 1.0], np.float32)
    for spec in specs(fam, n_random=1, widths=(0.5,)):
        sub, cfg = fam.extract(port, spec)
        ref_sub, ref_cfg = ref_fam.extract(params, ref_spec(spec))
        x = torch.as_tensor(toks)
        logits = fam.sub_logits(sub, cfg, x)
        want = ref_fam.sub_logits(ref_sub, ref_cfg, jnp.asarray(toks))
        assert logits.shape == want.shape
        np.testing.assert_allclose(logits.numpy(), np.asarray(want),
                                   atol=TOL, rtol=0)
        # the reference's sub_loss / sub_metric are its statistics of
        # these logits (one reference forward a spec keeps the test short)
        for name, stat in (("sub_loss", ref_elastic._lm_per_sample_ce),
                           ("sub_metric", ref_elastic._lm_per_sample_acc)):
            got = getattr(fam, name)(sub, cfg, x, None,
                                     torch.as_tensor(valid))
            ref = ref_elastic._weighted_mean(stat(want, jnp.asarray(toks)),
                                             jnp.asarray(valid))
            assert abs(float(got) - float(ref)) <= TOL
