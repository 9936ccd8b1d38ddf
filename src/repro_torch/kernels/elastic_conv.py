"""Channel-prefix elastic conv2d: the im2col lowering onto K1.

The port of the reference's ``kernels/elastic_conv.py`` (``_im2col``,
``elastic_conv2d``), which has no Pallas kernel of its own: each SAME conv
of the CNN parent's stages becomes one ``elastic_dense`` product (K1,
``csrc/elastic_dense.cu``) whose contraction is ordered **channel-major**
— index ``c · (kh·kw) + tap`` — so an input-channel prefix ``cin_active``
is the contraction prefix ``cin_active · kh · kw`` (K1's ``k_active``) and
an output-channel prefix ``cout_active`` the output-column prefix (K1's
``n_active``); K1 skips both (it does not multiply by zeros) and fuses the
bias at its write.

Client-stacked: x (G, B, H, W, Cin) with one weight (G, kh, kw, Cin,
Cout) and one bias (G, Cout) per client — K1's per-group weight and bias —
and (G,) int32 prefix tensors, so a cohort of different submodels is one
launch per conv. The patches are materialised (kh·kw × the activation,
the known cost of the lowering); they are built by ``Tensor.unfold`` on
the SAME-padded input, whose window axes (C, kh, kw) come out in exactly
the channel-major order, and their backward (col2im) is autograd's
``unfold`` backward. K1's backward (dx, dw, db) is its own VJP.

Semantics (as the dense masked path's, where inactive input channels are
already zero): ``y = (conv(x ⊙ cin_mask, w) + b) ⊙ cout_mask``;
``elastic_conv2d_plain`` computes exactly that with a direct convolution
(the tests' yardstick; the port never calls it on its kernel path).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.elastic_matmul import elastic_dense
from repro_torch.models.cnn import conv2d, pad_same


def _im2col(x, kh: int, kw: int, stride: int):
    """SAME-padded patches, channel-major contraction layout.

    x (G, B, H, W, C) -> (G, B·oh·ow, C·kh·kw) with contraction index
    c·(kh·kw) + tap (tap = i·kw + j), and the (B, oh, ow) geometry."""
    G, B, _, _, C = x.shape
    pat = pad_same(x, kh, kw, stride).unfold(-3, kh, stride) \
        .unfold(-3, kw, stride)               # (G, B, oh, ow, C, kh, kw)
    oh, ow = pat.shape[2:4]
    return pat.reshape(G, B * oh * ow, C * kh * kw), (B, oh, ow)


def conv_weight_matrix(w):
    """(kh, kw, Cin, Cout) -> (Cin·kh·kw, Cout), or per client (G, kh, kw,
    Cin, Cout) -> (G, Cin·kh·kw, Cout): the channel-major contraction."""
    kh, kw, cin, cout = w.shape[-4:]
    if w.dim() == 4:
        return w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return w.permute(0, 3, 1, 2, 4).reshape(w.shape[0], cin * kh * kw, cout)


def elastic_conv2d(x, w, b=None, *, stride: int = 1, cin_active=None,
                   cout_active=None):
    """Tile-skipping SAME conv. x (G, B, H, W, Cin); w (kh, kw, Cin, Cout)
    shared or (G, kh, kw, Cin, Cout) per client; b None, (Cout,) or
    (G, Cout); cin_active / cout_active: (G,) int32 channel prefixes or
    None (full). NHWC / HWIO, as ``models.cnn.conv2d``. Returns
    (G, B, oh, ow, Cout); differentiable in x, w and b."""
    kh, kw = w.shape[-4], w.shape[-3]
    pat, (B, oh, ow) = _im2col(x, kh, kw, stride)
    ka = None if cin_active is None else \
        (cin_active * (kh * kw)).to(torch.int32)
    y = elastic_dense(pat, conv_weight_matrix(w), b, k_active=ka,
                      n_active=cout_active)
    return y.reshape(x.shape[0], B, oh, ow, w.shape[-1])


def elastic_conv2d_plain(x, w, b=None, *, stride: int = 1, cin_active=None,
                         cout_active=None):
    """The plain version: a direct convolution of the input-masked x, plus
    the bias, times the output mask (same arguments as
    ``elastic_conv2d``)."""
    G = x.shape[0]
    cin, cout = w.shape[-2], w.shape[-1]
    dev = x.device
    if cin_active is not None:
        keep = torch.arange(cin, device=dev) < cin_active[:, None]
        x = x * keep[:, None, None, None, :].to(x.dtype)
    if w.dim() == 4:
        w = w.expand((G,) + w.shape)
    bias = torch.zeros((cout,), dtype=x.dtype, device=dev) if b is None \
        else b
    y = conv2d(x, w, bias.expand(G, cout), stride)
    if cout_active is not None:
        live = torch.arange(cout, device=dev) < cout_active[:, None]
        y = y * live[:, None, None, None, :].to(y.dtype)
    return y
