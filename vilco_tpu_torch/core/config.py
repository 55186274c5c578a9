"""The subset of vilco_tpu.core.config that the MQ serving and training
paths read.

Plain frozen dataclasses with no YAML dependency. `ModelConfig` holds only
what differs between the flagship and its tiny twin (widths, depths, heads,
classes, lengths, regression ranges), with the dataset dims already
propagated (what `Config.derived()` does there). What every MQ config
shares is fixed in the module that reads it: the identity neck and the
channel LayerNorms of the embedding, neck and heads, the absolute position
encoding, one XL stage (models/backbone.py), 3-tap convs and 3-layer heads
(models/point_transformer.py), drop-path scales and the 0.8 channel blend
(models/layers.py), stride-2 branch blocks (`fpn_strides`), multiclass
soft-NMS (ops/nms.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    backbone_arch: Tuple[int, ...] = (2, 2, 9)
    regression_range: Tuple[Tuple[float, float], ...] = (
        (0, 4), (2, 8), (4, 16), (8, 32), (16, 64), (32, 128),
        (64, 256), (128, 512), (256, 1024), (512, 10000),
    )
    n_head: int = 16
    embd_dim: int = 1024
    fpn_dim: int = 1024
    head_dim: int = 1024
    input_dim: int = 4096
    num_classes: int = 110
    max_seq_len: int = 1024

    @property
    def num_branch_layers(self) -> int:
        return self.backbone_arch[-1]

    @property
    def fpn_strides(self) -> Tuple[int, ...]:
        return tuple(2 ** i for i in range(self.num_branch_layers + 1))


@dataclass(frozen=True)
class TestCfg:
    __test__ = False  # not a pytest class

    pre_nms_thresh: float = 0.001
    pre_nms_topk: int = 2000
    min_score: float = 0.001
    max_seg_num: int = 200
    nms_sigma: float = 0.75
    duration_thresh: float = 0.05
    voting_thresh: float = 0.75


@dataclass(frozen=True)
class Config:
    """`batch_size` is `loader.batch_size`, `max_segments` is
    `dataset.max_segments` (the static GT padding per clip). The training
    constants every MQ config shares live in train/engine.py (losses, clip,
    loss normaliser), train/optim.py (AdamW, schedule) and models/layers.py
    (drop-path and XL dropout rates)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    test_cfg: TestCfg = field(default_factory=TestCfg)
    batch_size: int = 2
    max_segments: int = 64


def flagship_config(tiny: bool = False) -> Config:
    """The MQ ViLCo flagship (configs/mq_vilco.yaml), equal field by field
    to `__graft_entry__._flagship_cfg(tiny)`; the tiny twin with its XL
    stage on, as the port always runs it."""
    if tiny:
        model = ModelConfig(
            backbone_arch=(2, 1, 3), embd_dim=64, fpn_dim=64, head_dim=64,
            n_head=4,
            regression_range=((0, 4), (2, 8), (4, 16), (8, 10000)),
            input_dim=32, num_classes=12, max_seq_len=64,
        )
        return Config(model=model, batch_size=8, max_segments=8)
    return Config(model=ModelConfig())
