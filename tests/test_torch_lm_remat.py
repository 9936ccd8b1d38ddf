"""The zoo's batch-dict forward and remat against the reference
(``tests/test_torch_lm_loss.py``, whose parents, batches and reference
fixture this file shares): the forward's logits ≤1e-5, and remat on and
off bit-equal and against the reference's.
"""

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.models import transformer as PT

from test_torch_lm_loss import B, _close, _grads, _jb, _tb, ref

torch.set_num_threads(2)


def test_forward_batch_logits_match_reference(ref):
    """The batch-dict forward's logits and ``last_only`` on llava ≤1e-5."""
    rc, pc, params, batch = ref["llava-next-mistral-7b"]
    want, _ = RT.forward(params, rc, _jb(batch))
    p = params_from_numpy(params, device="cpu")
    got, _ = PT.forward_batch(p, pc, _tb(batch))
    _close([got], [want])
    last, _ = PT.forward_batch(p, pc, _tb(batch), last_only=True)
    assert last.shape == (B, 1, pc.padded_vocab)
    _close([last[:, 0]], [np.asarray(want)[:, -1]])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "qwen3-4b"])
def test_remat_on_off_bit_equal_and_matches_reference(ref, arch):
    """remat on and off: loss and gradients bit-equal in the port; remat
    on against the reference's remat ≤1e-5."""
    rc, pc, params, batch = ref[arch]
    runs = [_grads(lambda p: PT.loss_fn(p, pc, _tb(batch), remat=r), params)
            for r in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
    (want, _), wg = jax.value_and_grad(
        lambda p: RT.loss_fn(p, rc, _jb(batch), remat=True),
        has_aux=True)(params)
    _close([runs[1][0]], [want])
    _close(runs[1][2], wg)
