"""The subset of vilco_tpu.core.config that the MQ, NLQ and VQ serving and
training paths and their CL episodes read.

Plain frozen dataclasses; fields carry their JAX names, and YAML is read
only inside `load_config`. `DatasetCfg`, `LoaderCfg` and `VQConfig` are
JAX's `dataset`, `loader` and `vq` sections whole (VQConfig with what JAX's
VQ runner fixes beside them). `ModelConfig` holds only what differs between
the flagships and their tiny twins (variant, widths, depths, heads, window,
classes, lengths, regression ranges, drop-path), with the dataset dims
already propagated (what `Config.derived()` does there); `TrainCfg`,
`OptCfg` and `TestCfg` hold the `train_cfg`, `opt` and `test_cfg` values
the two differ in, and `CLCfg` the `cl_cfg` fields the MQ yaml's CL method
reads. What every config shares is fixed in the module that reads it: the
identity neck and the channel LayerNorms of the embedding, neck and heads,
the absolute position encoding, the MQ variant's XL stage of one layer
(`use_xl` says whether there is one) and the branch levels without text
cross-attention (models/backbone.py), 3-tap
convs and 3-layer heads (models/point_transformer.py), the 0.8 channel
blend (models/layers.py), stride-2 branch blocks (`fpn_strides`),
multiclass soft-NMS (ops/nms.py), radius center sampling, loss weight 1 and
clip 1.0 (train/engine.py), AdamW's betas, decay and eta_min
(train/optim.py); `_FIXED` lists them by their JAX names, and
`config_from_dict` refuses a config that sets another value.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

ATTENTION_IMPLS = ("xla", "flash", "pallas_naive")
VIT_ATTN_IMPLS = ("pallas", "flash")
COMPUTE_DTYPES = ("bfloat16", "float32")


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
    (train_cfg.dropout, copied by `Config.derived()`). `use_xl`: the MQ
    variant's long-context stage at branch level 0 is one XL relative
    attention (dropout `xl_dropout` in training); without it, one more
    stem block (`pre_branch`), as JAX builds it. `compute_dtype`: the
    episode's train and eval forwards (models/point_transformer.py)."""
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
    use_xl: bool = False
    xl_dropout: float = 0.1
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {self.attention_impl!r}: one "
                             f"of {ATTENTION_IMPLS}")
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {self.compute_dtype!r}: one of "
                             f"{COMPUTE_DTYPES}")

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
    ext_score_file: str = ""


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
    `adapt_blocks`), the task split (`num_tasks` of `classes_per_task`,
    read from the split pickle `pkl_file`) and the rehearsal memory
    (`memory_size` clips in all, saved to `path_memory` in the
    workdir)."""
    name: str = "naive"
    memory_size: int = 0
    pkl_file: str = ""
    path_memory: str = "path_memory.pkl"
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
    the batch's rows, in order (train/engine.py::make_train_step). The
    episode trains `total_epochs` a task; with `track_best` it evaluates
    every epoch from int(total_epochs x eval_start_ratio) on and restores
    the first epoch with the best `best_metric`."""
    learning_rate: float = 1e-4
    epochs: int = 10
    warmup_epochs: int = 5
    accumulation_steps: int = 1
    early_stop_epochs: int = 0
    track_best: bool = False
    eval_start_ratio: float = 1.0 / 3.0
    best_metric: str = "avg_mAP"

    @property
    def total_epochs(self) -> int:
        """early_stop_epochs, or epochs + warmup_epochs (JAX's OptCfg)."""
        if self.early_stop_epochs > 0:
            return self.early_stop_epochs
        return self.epochs + self.warmup_epochs


@dataclass(frozen=True)
class DatasetCfg:
    """JAX's `dataset` section (vilco_tpu/core/config.py::DatasetConfig),
    every field: what data/pipeline.py reads to turn video dicts into
    padded clips, and the feature folders of tasks/mq.py."""
    name: str = "ego4d_mq"
    json_file: str = ""
    feat_folder: Tuple[str, ...] = ()
    file_prefix: str = ""
    file_ext: Tuple[str, ...] = (".pt",)
    feat_stride: float = 1.0
    num_frames: float = 1.0
    default_fps: Optional[float] = None
    input_dim: int = 4096
    num_classes: int = 110
    downsample_rate: int = 1
    max_seq_len: int = 1024
    trunc_thresh: float = 0.3
    crop_ratio: Optional[Tuple[float, float]] = (0.9, 1.0)
    force_upsampling: bool = True
    use_text: bool = False
    text_feat_folder: str = ""
    use_narration: bool = False
    narration_feat_folder: str = ""
    narration_jsonl: str = ""
    max_text_len: int = 128
    max_narration_len: int = 128
    max_segments: int = 64
    train_jsonl_file: str = ""
    val_jsonl_file: str = ""
    video_feat_dir: str = ""
    text_feat_dir: str = ""
    val_text_feat_dir: str = ""
    input_txt_dim: int = 512
    enable_temporal_jittering: bool = False
    center_offset: bool = True


@dataclass(frozen=True)
class LoaderCfg:
    """JAX's `loader` section."""
    batch_size: int = 2
    num_workers: int = 0
    prefetch: int = 2


@dataclass(frozen=True)
class VQConfig:
    """JAX's `vq` section (vilco_tpu/core/config.py::VQCfg), every field
    under its JAX name, plus what JAX's VQ episode runner and model fix
    (`RUNNER_FIELDS`, not in JAX's section): `eval_windows` (windows per
    inference chunk), the head's dropout, the optimizer's clip norm and
    MultiStepLR milestones and factor, and `vit_attn_impl`, the ViT's
    attention: "pallas" (K1) or "flash" (K1f). `accumulation_steps` K: one
    optimizer step takes K micro-batches of the batch's rows (the yaml's
    1). `augment` switches the train batches' augmentation on
    (data/vq_augment.py); `vit_ckpt` is a DINO/DINOv2 checkpoint for the
    ViT (models/vit.py::load_torch_vit_checkpoint); `categories_per_task`
    groups real annotations into tasks. The query-frame ROI resample is
    not ported: `use_query_roi` true raises."""
    dim: int = 256
    clip_size: int = 448
    query_size: int = 448
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
    vit_ckpt: str = ""
    categories_per_task: int = 400
    batch_size: int = 4
    lr: float = 3e-4
    weight_decay: float = 5e-3
    use_hnm: bool = True
    augment: bool = True
    positive_threshold: float = 0.2
    positive_topk: int = 5
    use_query_roi: bool = False
    eval_windows: int = 8
    dropout: float = 0.2
    grad_max: float = 20.0
    lr_milestones: Tuple[int, ...] = (7000, 14000, 20000, 25000)
    lr_gamma: float = 0.3
    vit_attn_impl: str = "pallas"
    accumulation_steps: int = 1

    RUNNER_FIELDS = ("eval_windows", "dropout", "grad_max", "lr_milestones",
                     "lr_gamma", "vit_attn_impl")

    def __post_init__(self):
        if self.vit_attn_impl not in VIT_ATTN_IMPLS:
            raise ValueError(f"vit_attn_impl {self.vit_attn_impl!r}: one of "
                             f"{VIT_ATTN_IMPLS}")
        if self.use_query_roi:
            raise ValueError("vq.use_query_roi: the query-frame ROI resample "
                             "is not ported (ROADMAP §1 item 5)")

    def to_dict(self) -> Dict[str, Any]:
        """JAX's `VQCfg.to_dict()` layout: every field but RUNNER_FIELDS."""
        return {f.name: _thaw(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if f.name not in self.RUNNER_FIELDS}

    @classmethod
    def from_dict(cls, d: Optional[Mapping[str, Any]]) -> "VQConfig":
        """JAX's `vq` section (a yaml's, or `VQCfg.to_dict()`) -> VQConfig,
        RUNNER_FIELDS at their defaults. A key that is not a field of JAX's
        section raises."""
        d = dict(d or {})
        bad = sorted(set(d) - {f.name for f in dataclasses.fields(cls)}
                     | set(d) & set(cls.RUNNER_FIELDS))
        if bad:
            raise ValueError(f"vq.{bad[0]}: not a field of JAX's vq section")
        return cls(**{k: _freeze(v) for k, v in d.items()})


@dataclass(frozen=True)
class Config:
    """The top level: `task` (mq, nlq or vq), the task checkpoints' array
    format `ckpt_format` (npz only), the episode's seed `init_rand_seed`
    and the sections, `vq` (VQConfig) the VQ task's. `batch_size`, `max_segments`, `max_text_len` and
    `max_narration_len` read `loader.batch_size`, `dataset.max_segments`
    (the static GT padding per clip), `dataset.max_text_len` (text tokens
    per clip or query) and `dataset.max_narration_len` (narration tokens
    per clip). `to_dict()` gives JAX's `Config.to_dict()` layout, which
    `config_from_dict` reads back."""

    model: ModelConfig = field(default_factory=ModelConfig)
    test_cfg: TestCfg = field(default_factory=TestCfg)
    train_cfg: TrainCfg = field(default_factory=TrainCfg)
    opt: OptCfg = field(default_factory=OptCfg)
    cl_cfg: CLCfg = field(default_factory=CLCfg)
    dataset: DatasetCfg = field(default_factory=DatasetCfg)
    loader: LoaderCfg = field(default_factory=LoaderCfg)
    vq: VQConfig = field(default_factory=VQConfig)
    task: str = "mq"
    ckpt_format: str = "npz"
    init_rand_seed: int = 0

    @property
    def batch_size(self) -> int:
        return self.loader.batch_size

    @property
    def max_segments(self) -> int:
        return self.dataset.max_segments

    @property
    def max_text_len(self) -> int:
        return self.dataset.max_text_len

    @property
    def max_narration_len(self) -> int:
        return self.dataset.max_narration_len

    def to_dict(self) -> Dict[str, Any]:
        """JAX's `Config.to_dict()` layout (the episode's config.json), which
        vilco_tpu's `Config.from_dict` reads: the port's fields under their
        JAX names, with what the port fixes in its modules (`_FIXED`) and
        train_cfg's dropout and drop-path, which the model section holds
        here."""
        d = {name: dataclasses.asdict(getattr(self, name))
             for name in _SECTIONS}
        for (sec, name), v in _FIXED.items():
            d[sec][name] = v
        for name in ("dropout", "droppath"):
            d["train_cfg"][name] = getattr(self.model, name)
        d.update(task=self.task, ckpt_format=self.ckpt_format,
                 init_rand_seed=self.init_rand_seed, vq=self.vq.to_dict())
        return _thaw(d)


def _dataset(model: ModelConfig, **kw) -> DatasetCfg:
    """The dataset section of a config whose model is `model`: the dims
    `Config.derived()` copies into the model, and `kw`."""
    return DatasetCfg(input_dim=model.input_dim,
                      num_classes=model.num_classes,
                      max_seq_len=model.max_seq_len, **kw)


# vilco_tpu/data/synthetic.py::tiny_config()'s dataset, feat_stride and
# num_frames aside from the dims
_TINY_DATASET = dict(max_segments=8, max_text_len=16, max_narration_len=8,
                     feat_stride=16.0, num_frames=16.0)


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
            input_dim=32, num_classes=12, max_seq_len=64, use_xl=True,
        )
        return Config(model=model, dataset=_dataset(model, max_segments=8),
                      loader=LoaderCfg(batch_size=8))
    model = ModelConfig(use_xl=True)
    return Config(model=model, dataset=_dataset(model))


MQ_YAML_CL = CLCfg(name="l2p", memory_size=1010, prompt_pool=True,
                   narration_ssl=True, use_adapt=True,
                   adapt_blocks=(0, 1, 2, 3, 4),
                   pkl_file="./data/ego4d/ego4d_mq_query_incremental_22_all"
                            ".pkl",
                   path_memory="l2p_memory.pkl")
MQ_YAML_DATASET = dict(
    json_file="./data/ego4d/ego4d_clip_annotations_v2.json",
    feat_folder=("./data/ego4d/features/EgoVLPv2",),
    use_text=True,
    text_feat_folder="./data/ego4d/features/CLIP_text_features_mq",
    use_narration=True,
    narration_feat_folder="./data/ego4d/features/"
                          "em_narration_clip_token_features",
    narration_jsonl="./data/format_unique_pretrain_data_v2.jsonl")


def mq_yaml_config(tiny: bool = False) -> Config:
    """The MQ ViLCo flagship as configs/mq_vilco.yaml runs it: the graft
    flagship's model with the text tower and the branch blocks' text
    cross-attention (text 128 tokens of 768), dropout 0.1, the AL loss at
    0.2, the yaml's test_cfg (5000 candidates, sigma 0.99), and its CL
    method: L2P (10 prompts of 20 tokens, 4 chosen), narration SSL (128
    tokens of 512, a bank of 1010) and time adapters in branch blocks 0-4;
    5 tasks of 22 classes; its dataset section (the feature folders). The
    tiny twin is vilco_tpu/data/synthetic.py::tiny_config() with the same
    switches on and the XL stage (E=32, T=64, arch (2, 1, 3), 10 classes in
    5 tasks of 2, text 16 x 768, narration 8 x 512, no dropout or
    drop-path, AL weight 0.1, f32 compute)."""
    if tiny:
        model = ModelConfig(
            backbone_arch=(2, 1, 3), embd_dim=32, fpn_dim=32, head_dim=32,
            n_head=4,
            regression_range=((0, 4), (2, 8), (4, 16), (8, 10000)),
            input_dim=16, num_classes=10, max_seq_len=64, droppath=0.0,
            use_cross_modal=True, use_xl=True, compute_dtype="float32")
        return Config(
            model=model,
            test_cfg=TestCfg(pre_nms_topk=256, max_seg_num=20,
                             nms_sigma=0.9),
            train_cfg=TrainCfg(init_loss_norm=20.0, al_loss_weight=0.1),
            opt=OptCfg(learning_rate=2e-3, epochs=3, warmup_epochs=1),
            cl_cfg=dataclasses.replace(MQ_YAML_CL, classes_per_task=2,
                                       pkl_file="",
                                       path_memory="path_memory.pkl"),
            dataset=_dataset(model, use_text=True, use_narration=True,
                             **_TINY_DATASET))
    model = ModelConfig(dropout=0.1, use_cross_modal=True, use_xl=True)
    return Config(
        model=model,
        test_cfg=TestCfg(pre_nms_topk=5000, min_score=1e-4, nms_sigma=0.99,
                         duration_thresh=0.01, voting_thresh=0.9),
        train_cfg=TrainCfg(al_loss_weight=0.2),
        cl_cfg=MQ_YAML_CL, dataset=_dataset(model, **MQ_YAML_DATASET))


NLQ_YAML_CL = CLCfg(name="ewc", memory_size=0, reg_lambda=3000.0,
                    embed_dim=512, num_tasks=13,
                    pkl_file="./ego4d_data/ego4d_nlq_query_incremental_13"
                             ".pkl")


def nlq_flagship_config(tiny: bool = False) -> Config:
    """The NLQ ViLCo flagship (configs/nlq_vilco.yaml): the dual tower at
    T=2560 with 9-wide banded attention, 4 heads of 96, one class, text of
    32 tokens x 512, and the yaml's CL method: EWC at lambda 3000 over 13
    tasks, no rehearsal memory. The tiny twin is vilco_tpu/tasks/nlq.py::
    nlq_tiny_config() (E=32, T=64, arch (2, 1, 1, 0, 3), no drop-path)."""
    nlq_data = dict(use_text=True, force_upsampling=False,
                    center_offset=False, crop_ratio=None)
    if tiny:
        model = ModelConfig(
            variant="nlq", backbone_arch=(2, 1, 1, 0, 3), n_mha_win_size=9,
            embd_dim=32, fpn_dim=32, head_dim=32, n_head=4, n_txt_in=12,
            regression_range=((0, 4), (2, 8), (4, 16), (8, 10000)),
            input_dim=16, num_classes=1, max_seq_len=64, droppath=0.0,
            use_cross_modal=True, compute_dtype="float32",
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
            dataset=_dataset(model, max_segments=4, max_text_len=8,
                             feat_stride=16.0, num_frames=16.0,
                             input_txt_dim=12, **nlq_data),
            loader=LoaderCfg(batch_size=4), task="nlq")
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
        opt=OptCfg(epochs=8, warmup_epochs=5, best_metric="avg_R1@0.3"),
        cl_cfg=NLQ_YAML_CL,
        dataset=_dataset(
            model, name="ego4d_nlq", feat_stride=16.043,
            num_frames=16.043, default_fps=30.0, max_text_len=32,
            train_jsonl_file="./ego4d_data/ego4d_nlq_train_v2.jsonl",
            val_jsonl_file="./ego4d_data/ego4d_nlq_val_v2.jsonl",
            video_feat_dir="./features/egovlp",
            text_feat_dir="./features/CLIP_text_features_train",
            val_text_feat_dir="./features/CLIP_text_features_val",
            **nlq_data),
        loader=LoaderCfg(batch_size=4), task="nlq")


# ------------------------------------------------ JAX's Config.to_dict()

_SECTIONS = {"model": ModelConfig, "test_cfg": TestCfg,
             "train_cfg": TrainCfg, "opt": OptCfg, "cl_cfg": CLCfg,
             "dataset": DatasetCfg, "loader": LoaderCfg}

# JAX fields whose value the port's modules fix (docstring above): a config
# that sets another value is refused
_FIXED = {
    ("model", "name"): "point_transformer",
    ("model", "backbone_type"): "convTransformer",
    ("model", "fpn_type"): "identity",
    ("model", "scale_factor"): 2,
    ("model", "embd_kernel_size"): 3,
    ("model", "embd_with_ln"): True,
    ("model", "fpn_with_ln"): True,
    ("model", "fpn_start_level"): 0,
    ("model", "head_kernel_size"): 3,
    ("model", "head_num_layers"): 3,
    ("model", "head_with_ln"): True,
    ("model", "max_buffer_len_factor"): 1.0,
    ("model", "use_abs_pe"): True,
    ("model", "use_rel_pe"): False,
    ("model", "xl_layers"): 1,
    ("model", "xl_d_inner"): 2048,
    ("model", "t_c_alpha"): 0.8,
    ("model", "cross_modal_skip_levels"): (1, 2),
    ("train_cfg", "center_sample"): "radius",
    ("train_cfg", "center_sample_radius"): 1.5,
    ("train_cfg", "loss_weight"): 1.0,
    ("train_cfg", "cls_prior_prob"): 0.01,
    ("train_cfg", "clip_grad_l2norm"): 1.0,
    ("train_cfg", "t_c_alpha"): 0.8,
    ("test_cfg", "nms_method"): "soft",
    ("test_cfg", "multiclass_nms"): True,
    ("opt", "type"): "adamw",
    ("opt", "weight_decay"): 0.05,
    ("opt", "warmup"): True,
    ("opt", "schedule_type"): "cosine",
    ("opt", "schedule_steps"): (),
    ("opt", "eta_min"): 1e-8,
    ("opt", "mu_dtype"): "bfloat16",
    ("opt", "nu_dtype"): "bfloat16",
    ("opt", "second_moment"): "full",
    ("opt", "param_compute_dtype"): "float32",
}
# why the port refuses the fixed fields it cannot honour, by field
_UNSUPPORTED = {
    ("opt", "mu_dtype"): "FusedAdamW keeps bf16 moments "
                         "(train/optim.py::MOMENT_DTYPE)",
    ("opt", "nu_dtype"): "FusedAdamW keeps bf16 moments "
                         "(train/optim.py::MOMENT_DTYPE)",
    ("opt", "second_moment"): "the port's AdamW keeps the full second "
                              "moment; the factored one is not ported",
    ("opt", "param_compute_dtype"): "the port casts its f32 masters on "
                                    "use; a persistent bf16 copy is not "
                                    "ported",
}
# JAX fields no path of the port reads: the knobs of JAX's own kernels and
# optimizer forms (the same math), the hard-NMS threshold, the model EMA
# (the episode never starts one), and options the MQ episode ignores in JAX
# too
_IGNORED = {
    ("model", "fused_xl"), ("model", "remat_xl"),
    ("model", "fused_attention"), ("model", "fused_conv"),
    ("model", "xl_mem_len"),
    ("train_cfg", "dropout"), ("train_cfg", "droppath"),
    ("test_cfg", "iou_threshold"),
    ("opt", "momentum"), ("opt", "schedule_gamma"), ("opt", "flatten"),
    ("opt", "fused_apply"), ("opt", "ema_decay"),
    ("cl_cfg", "random_order"), ("cl_cfg", "type_sampling"),
}
_IGNORED_TOP = ("train_split", "val_split", "output_folder")


def _freeze(v):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def _thaw(v):
    if isinstance(v, dict):
        return {k: _thaw(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_thaw(x) for x in v]
    return v


def config_from_dict(d: Mapping[str, Any]) -> Config:
    """A JAX config as a dict (`Config.to_dict()`, the config.json that the
    episode persists, or a yaml read as it is) -> the port's Config, with
    what JAX's `Config.derived()` does: the dataset's dims, train_cfg's
    dropout and drop-path into the model, cl_cfg.embed_dim to the text
    dim. A key the port does not know, a fixed field set to another value
    (`_FIXED`) and `ckpt_format` "orbax" raise a ValueError naming the
    field."""
    d = dict(d)
    d_train = dict(d.get("train_cfg") or {})
    kw: Dict[str, Any] = {}
    for sec, cls in _SECTIONS.items():
        raw = dict(d.pop(sec, None) or {})
        names = {f.name for f in dataclasses.fields(cls)}
        for key, v in raw.items():
            where = f"{sec}.{key}"
            if (sec, key) in _FIXED:
                if _freeze(v) != _FIXED[(sec, key)]:
                    why = _UNSUPPORTED.get(
                        (sec, key), "the port fixes it in its modules")
                    raise ValueError(f"{where}={v!r}: the port runs only "
                                     f"{_FIXED[(sec, key)]!r} ({why})")
            elif key not in names and (sec, key) not in _IGNORED:
                raise ValueError(f"{where}: not a field of the port's "
                                 f"config")
        kw[sec] = {k: _freeze(v) for k, v in raw.items() if k in names}
    top = {}
    for key, v in d.items():
        if key in ("task", "ckpt_format", "init_rand_seed"):
            top[key] = v
        elif key == "vq":
            top[key] = VQConfig.from_dict(v)
        elif key not in _IGNORED_TOP:
            raise ValueError(f"{key}: not a field of the port's config")
    if top.get("ckpt_format", "npz") != "npz":
        raise ValueError(f"ckpt_format={top['ckpt_format']!r}: the port "
                         "writes npz checkpoints only (orbax needs JAX)")
    ds = DatasetCfg(**kw["dataset"])
    # Config.derived(): the dataset's dims and train_cfg's dropout and
    # drop-path (JAX's defaults 0 and 0.1) go to the model
    model = ModelConfig(**{
        **kw["model"], "input_dim": ds.input_dim,
        "num_classes": ds.num_classes, "max_seq_len": ds.max_seq_len,
        "dropout": d_train.get("dropout", 0.0),
        "droppath": d_train.get("droppath", 0.1)})
    cl = CLCfg(**kw["cl_cfg"])
    if cl.embed_dim != model.n_txt_in:
        cl = dataclasses.replace(cl, embed_dim=model.n_txt_in)
    return Config(model=model, test_cfg=TestCfg(**kw["test_cfg"]),
                  train_cfg=TrainCfg(**kw["train_cfg"]),
                  opt=OptCfg(**kw["opt"]), cl_cfg=cl, dataset=ds,
                  loader=LoaderCfg(**kw["loader"]), **top)


def load_config(path: str) -> Config:
    """A JAX config file -> the port's Config (`config_from_dict`). A .json
    file (the episode's config.json) is read with json, which gives what
    YAML gives for it; other files with PyYAML, imported here only."""
    with open(path) as f:
        if path.endswith(".json"):
            raw = json.load(f)
        else:
            import yaml

            raw = yaml.safe_load(f)
    return config_from_dict(raw or {})


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
        return VQConfig(dim=64, clip_size=64, query_size=64, patch_size=8,
                        vit_dim=48, vit_depth=2, vit_heads=4,
                        resolution_transformer=4, resolution_anchor_feat=8,
                        num_transformer=1, window_transformer=5,
                        num_frames=6, batch_size=2, eval_windows=4)
    return VQConfig()
