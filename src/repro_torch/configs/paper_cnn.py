"""The paper's own parent model: an elastic residual CNN (OFA-style) —
the port of the reference's ``configs/paper_cnn.py``, unchanged.

The paper uses a once-for-all MobileNetV3 with elastic depth/width and
layer-wise RL gates. The same *elasticity contract* is kept on a residual
CNN with grouped stages — the layer-group structure Alg. 3's alignment
assumes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-elastic-cnn"
    in_channels: int = 3
    image_size: int = 32
    n_classes: int = 10
    stem_channels: int = 32
    # per-stage (channels, max_blocks); stages downsample 2x each
    stages: Tuple[Tuple[int, int], ...] = ((32, 3), (64, 3), (128, 3))
    groupnorm_groups: int = 8
    gate_hidden: int = 32          # RL gate MLP hidden size
    elastic_widths: Tuple[float, ...] = (0.25, 0.5, 0.75, 1.0)

    @property
    def n_blocks(self) -> int:
        return sum(b for _, b in self.stages)


PAPER_CNN = CNNConfig()
MNIST_CNN = CNNConfig(name="paper-elastic-cnn-mnist", in_channels=1,
                      image_size=28)
