"""Shared set-up of the tests of the zoo's last three decoder parents
(``tests/test_torch_mla.py``, ``test_torch_attn_pair.py``,
``test_torch_hybrid.py``, ``test_torch_a11_family.py``): each parent
reduced the same way in both packages, the reference's parameters bridged,
specs that cut each elastic dim, the reference's client-stacked forward
and its ``EdgeServer``, and the port's teacher-forced decode of an
extracted submodel.

* deepseek-v2-lite-16b (MLA, MoE with one shared expert): d_model 64, 2
  query heads, the dense first layer (d_ff 128) as a segment of its own,
  then 2 MoE layers of 4 experts, top 2.
* gemma2-9b (local / global pairs, softcaps, post-norms): d_model 64, 4
  query / 2 KV heads of 16 so that the head prefix is elastic, 2 pairs,
  the local window 8 so that it binds at 32 tokens.
* zamba2-1.2b (Mamba2 and the shared attention block): d_model 64, a
  segment of 1 SSM layer with the shared block after it and one of 2, 4
  SSD heads, the shared block's window 16 so that it binds at 32 tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced as ref_reduced
from repro.core.submodel import TransformerSubSpec as RefSpec
from repro.models import transformer as RT
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import Segment
from repro_torch.core.submodel import TransformerSubSpec
from repro_torch.models import transformer as PT

import jax_compile_cache  # noqa: F401  (the shared compile cache)

TOL = 1e-5
SLICE_TOL = 1e-4
PARENTS = ("deepseek-v2-lite-16b", "gemma2-9b", "zamba2-1.2b")


def _reshape(cfg, name, segment_type, **moe_kw):
    """The reduced config of ``name`` in one package (``segment_type`` its
    ``Segment`` class), reshaped as the module docstring says."""
    if name == "deepseek-v2-lite-16b":
        cfg = dataclasses.replace(
            cfg, segments=(segment_type(kind="attn", n_layers=1),
                           segment_type(kind="attn", n_layers=2,
                                        use_moe=True)),
            n_layers=3, moe=dataclasses.replace(cfg.moe, **moe_kw))
    elif name == "gemma2-9b":
        cfg = dataclasses.replace(
            cfg, n_heads=4, n_kv_heads=2, head_dim=16,
            segments=(dataclasses.replace(cfg.segments[0],
                                          pair_local_window=8),))
    else:
        cfg = dataclasses.replace(cfg, sliding_window=16)
    return cfg


def configs(name, **moe_kw):
    """(port, reference) reduced configs of one parent."""
    from repro.configs.base import Segment as RefSegment
    n_layers = {"gemma2-9b": 4, "zamba2-1.2b": 3}.get(name, 2)
    port = _reshape(reduced(ARCHS[name], n_layers=n_layers, d_model=64),
                    name, Segment, **moe_kw)
    ref = _reshape(ref_reduced(REF_ARCHS[name], n_layers=n_layers,
                               d_model=64), name, RefSegment, **moe_kw)
    return port, ref


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_params(ref_cfg, seed=0):
    return np_tree(RT.init_params(jax.random.PRNGKey(seed), ref_cfg))


def ref_spec(s):
    return RefSpec(s.layers, s.ff_frac, s.expert_frac, s.ssm_head_frac,
                   s.attn_head_frac)


def cohort_specs(name):
    """Three clients' specs cutting each of the parent's elastic dims and
    its depth."""
    if name == "deepseek-v2-lite-16b":
        return [TransformerSubSpec(((0,), (0, 1))),
                TransformerSubSpec(((0,), (1,)), expert_frac=0.75,
                                   ff_frac=0.5),
                TransformerSubSpec(((0,), (0, 1)), expert_frac=0.5,
                                   ff_frac=0.25)]
    if name == "gemma2-9b":
        return [TransformerSubSpec(((0, 1),)),
                TransformerSubSpec(((0, 1),), attn_head_frac=0.5),
                TransformerSubSpec(((1,),), ff_frac=0.5, attn_head_frac=0.5)]
    return [TransformerSubSpec(((0,), (0, 1))),
            TransformerSubSpec(((0,), (1,)), ssm_head_frac=0.5),
            TransformerSubSpec(((0,), (0, 1)), ssm_head_frac=0.25,
                               ff_frac=0.5)]


def stacked_params(base, G, seed):
    """G clients' parameters: the reference's, each jittered."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a[None] + 0.01 * rng.standard_normal(
        (G,) + a.shape)).astype(np.float32), base)


def ref_cohort_logits(ref_cfg, stacked, ref_masks_fwd, toks):
    """The reference's forward vmapped over clients (each its own
    parameters and masks)."""
    return jax.jit(jax.vmap(lambda p, m, t: RT.forward(
        p, ref_cfg, {"tokens": t}, masks=m)[0]))(
        stacked, ref_masks_fwd, jnp.asarray(toks))


def extracted_decode(fam, params, spec, prompt, tokens, max_len):
    """Teacher-forced decode of the tenant's *extracted* submodel (the
    port's own) over the prompt and the server's generated tokens — the
    logits at positions len(prompt)-1 .. end, aligned with the server's
    traced logits (the reference's ``tests/test_serving.py``)."""
    import torch
    sub, sub_cfg = fam.extract(params, spec)
    caches = PT.init_decode_caches(sub_cfg, 1, max_len, device="cpu")
    out = []
    seq = list(prompt) + list(tokens[:-1])
    for i, t in enumerate(seq):
        logits, caches = PT.decode_step(
            sub, sub_cfg, caches, torch.tensor([[int(t)]]),
            torch.tensor([i]))
        if i >= len(prompt) - 1:
            out.append(logits[0].numpy())
    return out


def bridged(params):
    return params_from_numpy(params, device="cpu")
