"""The subset of vilco_tpu.core.config that the MQ, NLQ and VQ serving and
training paths read.

Plain frozen dataclasses with no YAML dependency; fields carry their JAX
names. `ModelConfig` holds only what differs between the flagships and
their tiny twins (variant, widths, depths, heads, window, classes, lengths,
regression ranges, drop-path), with the dataset dims already propagated
(what `Config.derived()` does there); `TrainCfg`, `OptCfg` and `TestCfg`
hold the `train_cfg`, `opt` and `test_cfg` values the two differ in, and
`CLCfg` the `cl_cfg` fields the MQ yaml's CL method reads. What every
config shares is fixed in the module that reads it: the identity
neck and the channel LayerNorms of the embedding, neck and heads, the
absolute position encoding, the MQ variant's one XL stage
and the branch levels without text cross-attention (models/backbone.py),
3-tap convs and 3-layer heads
(models/point_transformer.py), the 0.8 channel blend (models/layers.py),
stride-2 branch blocks (`fpn_strides`), multiclass soft-NMS (ops/nms.py),
radius center sampling, loss weight 1 and clip 1.0 (train/engine.py),
AdamW's betas, decay and eta_min (train/optim.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

ATTENTION_IMPLS = ("xla", "flash", "pallas_naive")
VIT_ATTN_IMPLS = ("pallas", "flash")


@dataclass(frozen=True)
class ModelConfig:
    """`variant` "mq": backbone_arch (convs, stem, branch), one XL stage;
    "nlq": (convs, txt_stem, vid_stem, cross_branch, plain_branch), the
    dual tower. `n_mha_win_size` is the total attention window (the half
    window w = size // 2), -1 for dense attention. `attention_impl` picks
    the dense self-attention of the MQ stem and branch blocks: "xla" (K1,
    the kernel JAX's default runs on a TPU), "flash" (K1f) or
    "pallas_naive" (K1n). `use_cross_modal` builds the MQ text tower and
    the branch blocks' text cross-attention (the NLQ dual tower always has
    its text tower and ignores it); `dropout` is the blocks' proj_drop
    (train_cfg.dropout, copied by `Config.derived()`)."""
    variant: str = "mq"
    backbone_arch: Tuple[int, ...] = (2, 2, 9)
    regression_range: Tuple[Tuple[float, float], ...] = (
        (0, 4), (2, 8), (4, 16), (8, 32), (16, 64), (32, 128),
        (64, 256), (128, 512), (256, 1024), (512, 10000),
    )
    n_head: int = 16
    n_mha_win_size: int = -1
    embd_dim: int = 1024
    fpn_dim: int = 1024
    head_dim: int = 1024
    n_txt_in: int = 768
    input_dim: int = 4096
    num_classes: int = 110
    max_seq_len: int = 1024
    droppath: float = 0.1
    dropout: float = 0.0
    use_cross_modal: bool = False
    attention_impl: str = "xla"

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r}: one "
                             f"of {ATTENTION_IMPLS}")

    @property
    def num_branch_layers(self) -> int:
        if len(self.backbone_arch) == 5:
            return self.backbone_arch[3] + self.backbone_arch[4]
        return self.backbone_arch[-1]

    @property
    def window(self) -> int:
        """Half window of the banded attention, -1 for dense."""
        return self.n_mha_win_size // 2 if self.n_mha_win_size > 1 else -1

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
class TrainCfg:
    """MQ weights its losses by the learned per-class Gaussians; NLQ does
    not, and smooths its labels. `al_loss_weight` weights the
    label-involved loss (0: off); `temperature` is the narration-SSL
    InfoNCE's."""
    label_smoothing: float = 0.0
    use_gaussian_weights: bool = True
    init_loss_norm: float = 100.0
    al_loss_weight: float = 0.0
    temperature: float = 0.07


@dataclass(frozen=True)
class CLCfg:
    """The `cl_cfg` fields the CL methods read: `name` (naive, l2p, ewc,
    mas, icarl or bic), the EWC/MAS penalty's weight `reg_lambda`, the
    iCaRL/BiC distillation weight `dist_factor`, the L2P prompt pool
    (`prompt_pool`, `pool_size` prompts of `length` tokens of `embed_dim`,
    `topk` chosen), narration SSL (`narration_ssl`, narration tokens of
    `narration_dim`, weight `ssl_factor`, a memory bank of `memory_size`
    rows), the time adapters (`use_adapt` in the branch blocks
    `adapt_blocks`) and the task split (`num_tasks` of
    `classes_per_task`)."""
    name: str = "naive"
    memory_size: int = 0
    reg_lambda: float = 0.0
    dist_factor: float = 0.01
    prompt_pool: bool = False
    pool_size: int = 10
    topk: int = 4
    length: int = 20
    embed_dim: int = 768
    narration_ssl: bool = False
    narration_dim: int = 512
    ssl_factor: float = 0.03
    use_adapt: bool = False
    adapt_blocks: Tuple[int, ...] = ()
    num_tasks: int = 5
    classes_per_task: int = 22


@dataclass(frozen=True)
class OptCfg:
    """`accumulation_steps` K: one optimizer step takes K micro-batches of
    the batch's rows, in order (train/engine.py::make_train_step)."""
    learning_rate: float = 1e-4
    epochs: int = 10
    warmup_epochs: int = 5
    accumulation_steps: int = 1


@dataclass(frozen=True)
class Config:
    """`batch_size` is `loader.batch_size`; `max_segments`,
    `max_text_len` and `max_narration_len` are `dataset.max_segments` (the
    static GT padding per clip), `dataset.max_text_len` (text tokens per
    clip or query) and `dataset.max_narration_len` (narration tokens per
    clip)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    test_cfg: TestCfg = field(default_factory=TestCfg)
    train_cfg: TrainCfg = field(default_factory=TrainCfg)
    opt: OptCfg = field(default_factory=OptCfg)
    cl_cfg: CLCfg = field(default_factory=CLCfg)
    batch_size: int = 2
    max_segments: int = 64
    max_text_len: int = 128
    max_narration_len: int = 128


def flagship_config(tiny: bool = False) -> Config:
    """The MQ ViLCo flagship as `__graft_entry__._flagship_cfg(tiny)`
    builds it, equal to it field by field; the tiny twin with its XL stage
    on, as the port always runs it, naive CL method and no text.
    configs/mq_vilco.yaml is `mq_yaml_config()`."""
    if tiny:
        model = ModelConfig(
            backbone_arch=(2, 1, 3), embd_dim=64, fpn_dim=64, head_dim=64,
            n_head=4,
            regression_range=((0, 4), (2, 8), (4, 16), (8, 10000)),
            input_dim=32, num_classes=12, max_seq_len=64,
        )
        return Config(model=model, batch_size=8, max_segments=8)
    return Config(model=ModelConfig())


MQ_YAML_CL = CLCfg(name="l2p", memory_size=1010, prompt_pool=True,
                   narration_ssl=True, use_adapt=True,
                   adapt_blocks=(0, 1, 2, 3, 4))


def mq_yaml_config(tiny: bool = False) -> Config:
    """The MQ ViLCo flagship as configs/mq_vilco.yaml runs it: the graft
    flagship's model with the text tower and the branch blocks' text
    cross-attention (text 128 tokens of 768), dropout 0.1, the AL loss at
    0.2, the yaml's test_cfg (5000 candidates, sigma 0.99), and its CL
    method: L2P (10 prompts of 20 tokens, 4 chosen), narration SSL (128
    tokens of 512, a bank of 1010) and time adapters in branch blocks 0-4;
    5 tasks of 22 classes. The tiny twin is vilco_tpu/data/synthetic.py::
    tiny_config() with the same switches on and the XL stage (E=32, T=64,
    arch (2, 1, 3), 10 classes in 5 tasks of 2, text 16 x 768, narration
    8 x 512, no dropout or drop-path, AL weight 0.1)."""
    if tiny:
        model = ModelConfig(
            backbone_arch=(2, 1, 3), embd_dim=32, fpn_dim=32, head_dim=32,
            n_head=4,
            regression_range=((0, 4), (2, 8), (4, 16), (8, 10000)),
            input_dim=16, num_classes=10, max_seq_len=64, droppath=0.0,
            use_cross_modal=True)
        return Config(
            model=model,
            test_cfg=TestCfg(pre_nms_topk=256, max_seg_num=20,
                             nms_sigma=0.9),
            train_cfg=TrainCfg(init_loss_norm=20.0, al_loss_weight=0.1),
            opt=OptCfg(learning_rate=2e-3, epochs=3, warmup_epochs=1),
            cl_cfg=dataclasses.replace(MQ_YAML_CL, classes_per_task=2),
            batch_size=2, max_segments=8, max_text_len=16,
            max_narration_len=8)
    return Config(
        model=ModelConfig(dropout=0.1, use_cross_modal=True),
        test_cfg=TestCfg(pre_nms_topk=5000, min_score=1e-4, nms_sigma=0.99,
                         duration_thresh=0.01, voting_thresh=0.9),
        train_cfg=TrainCfg(al_loss_weight=0.2),
        cl_cfg=MQ_YAML_CL)


NLQ_YAML_CL = CLCfg(name="ewc", memory_size=0, reg_lambda=3000.0,
                    embed_dim=512, num_tasks=13)


def nlq_flagship_config(tiny: bool = False) -> Config:
    """The NLQ ViLCo flagship (configs/nlq_vilco.yaml): the dual tower at
    T=2560 with 9-wide banded attention, 4 heads of 96, one class, text of
    32 tokens x 512, and the yaml's CL method: EWC at lambda 3000 over 13
    tasks, no rehearsal memory. The tiny twin is vilco_tpu/tasks/nlq.py::
    nlq_tiny_config() (E=32, T=64, arch (2, 1, 1, 0, 3), no drop-path)."""
    if tiny:
        model = ModelConfig(
            variant="nlq", backbone_arch=(2, 1, 1, 0, 3), n_mha_win_size=9,
            embd_dim=32, fpn_dim=32, head_dim=32, n_head=4, n_txt_in=12,
            regression_range=((0, 4), (2, 8), (4, 16), (8, 10000)),
            input_dim=16, num_classes=1, max_seq_len=64, droppath=0.0,
            use_cross_modal=True,
        )
        return Config(
            model=model,
            test_cfg=TestCfg(pre_nms_topk=128, max_seg_num=5,
                             duration_thresh=0.001),
            train_cfg=TrainCfg(label_smoothing=0.1,
                               use_gaussian_weights=False,
                               init_loss_norm=20.0),
            opt=OptCfg(learning_rate=3e-3, epochs=6, warmup_epochs=1),
            cl_cfg=CLCfg(embed_dim=12, num_tasks=3, classes_per_task=1),
            batch_size=4, max_segments=4, max_text_len=8)
    model = ModelConfig(
        variant="nlq", backbone_arch=(2, 4, 4, 0, 6), n_mha_win_size=9,
        embd_dim=384, fpn_dim=384, head_dim=384, n_head=4, n_txt_in=512,
        regression_range=((0, 4), (2, 8), (4, 16), (8, 32), (16, 64),
                          (32, 128), (64, 10000)),
        input_dim=256, num_classes=1, max_seq_len=2560,
    )
    return Config(
        model=model,
        test_cfg=TestCfg(max_seg_num=5, duration_thresh=0.001,
                         voting_thresh=0.9),
        train_cfg=TrainCfg(label_smoothing=0.1, use_gaussian_weights=False,
                           init_loss_norm=200.0),
        opt=OptCfg(epochs=8, warmup_epochs=5), cl_cfg=NLQ_YAML_CL,
        batch_size=4, max_segments=64, max_text_len=32)


@dataclass(frozen=True)
class VQConfig:
    """The `vq` section (vilco_tpu/core/config.py::VQCfg) fields the VQ
    serving path and train step read, with their JAX names, plus what the
    VQ episode runner fixes: `eval_windows` (windows per inference chunk),
    the head's dropout and the optimizer's clip norm and MultiStepLR
    milestones and factor. `accumulation_steps` K: one optimizer step takes
    K micro-batches of the batch's rows (the yaml's 1); the query crop has
    the clips' size.
    `vit_attn_impl` picks the ViT's attention: "pallas" (K1) or "flash"
    (K1f)."""
    dim: int = 256
    clip_size: int = 448
    patch_size: int = 14
    vit_dim: int = 768
    vit_depth: int = 12
    vit_heads: int = 12
    resolution_transformer: int = 8
    resolution_anchor_feat: int = 16
    num_transformer: int = 3
    window_transformer: int = 5
    num_frames: int = 30
    freeze_backbone: bool = True
    batch_size: int = 4
    lr: float = 3e-4
    weight_decay: float = 5e-3
    use_hnm: bool = True
    positive_threshold: float = 0.2
    positive_topk: int = 5
    eval_windows: int = 8
    dropout: float = 0.2
    grad_max: float = 20.0
    lr_milestones: Tuple[int, ...] = (7000, 14000, 20000, 25000)
    lr_gamma: float = 0.3
    vit_attn_impl: str = "pallas"
    accumulation_steps: int = 1

    def __post_init__(self):
        if self.vit_attn_impl not in VIT_ATTN_IMPLS:
            raise ValueError(f"vit_attn_impl {self.vit_attn_impl!r}: one of "
                             f"{VIT_ATTN_IMPLS}")


def vq_flagship_config(tiny: bool = False) -> VQConfig:
    """The VQ ViLCo flagship (configs/vq_vilco.yaml): a frozen ViT-B/14 on
    448-square frames (32 x 32 patches + CLS = 1025 tokens), a dim-256
    matcher over 30-frame windows, 3 spatio-temporal layers of 8 heads over
    R = 8 (64 tokens a frame) with a +-2-frame band, anchors on a 16 x 16
    grid. The tiny twin keeps every structure the flagship runs (the toy
    geometry of vilco_tpu/tasks/vq.py skips two): 8 x 8 patches, one
    stride-2 down head (8 -> R = 4) and one transposed-conv up step
    (R = 4 -> anchor grid 8); chunks of 4 windows."""
    if tiny:
        return VQConfig(dim=64, clip_size=64, patch_size=8,
                        vit_dim=48, vit_depth=2, vit_heads=4,
                        resolution_transformer=4, resolution_anchor_feat=8,
                        num_transformer=1, window_transformer=5,
                        num_frames=6, batch_size=2, eval_windows=4)
    return VQConfig()
