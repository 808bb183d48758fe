"""TEMPURA run configuration (CLI surface).

The port's own copy of ``vidsgg/configs/tempura.py``. Flag names, defaults,
and mode-derived overrides mirror the reference's
``tools/utils/tempura_config.py`` exactly (:25-38 for the overrides and
"None"-string normalization), so reference command lines (docker_cmd.txt)
port over unchanged. Internally this resolves to the typed model config
(:class:`vidsgg_torch.models.tempura.TempuraConfig`) plus the loss flags
(:class:`vidsgg_torch.train.steps.LossFlags`).
"""

from __future__ import annotations

import dataclasses
from argparse import ArgumentParser

import torch

from vidsgg_torch.models.tempura import TempuraConfig
from vidsgg_torch.train.steps import LossFlags


@dataclasses.dataclass
class TempuraRunConfig:
    mode: str = "predcls"
    save_path: str = "checkpoint/"
    model_path: str | None = None
    data_path: str = "/data/AG/"
    output_path: str = "output/"
    datasize: str = "large"
    lr: float = 1e-5
    warmup: int = 3
    nepoch: int = 10
    use_ctl_loss: bool = False
    use_cons_str_loss: bool = False
    use_cons_sem_loss: bool = False
    optimizer: str = "adamw"
    enc_layer: int = 1
    dec_layer: int = 3
    log_iter: int = 100
    obj_head: str = "linear"
    rel_head: str = "gmm"
    K: int = 6
    tracking: bool = False
    rel_mem_compute: str | None = "joint"
    obj_mem_compute: bool = False
    take_obj_mem_feat: bool = False
    obj_mem_weight_type: str = "simple"
    rel_mem_weight_type: str = "simple"
    mem_fusion: str = "late"
    mem_feat_selection: str = "manual"
    mem_feat_lambda: float = 0.5
    pseudo_thresh: int = 7
    obj_unc: bool = False
    rel_unc: bool = False
    obj_loss_weighting: str | None = None
    rel_loss_weighting: str | None = None
    mlm: bool = False
    eos_coef: float = 1.0
    obj_con_loss: str | None = None
    rel_con_loss: bool = False
    lambda_con: float = 1.0
    seed: int = 1123  # reference env.py:6-13
    # no reference counterpart (the reference is single-GPU): videos per
    # data-parallel group; 1 = single device, 0 = all local devices
    data_parallel: int = 1
    # rehearsal/dev hooks (the reference hardcodes min-side 600 and the
    # full ResNet-101): frame resize target, shrunk detector, and the
    # largest frame-count bucket
    frame_size: int = 600
    tiny_detector: bool = False
    bucket_frames: int = 64
    # sgdet eval: videos per detect dispatch. 1 = single-video.
    pair_detect: int = 1
    # serving-only int8 PTQ of the detector convs, calibrated on the first
    # int8_calib videos
    int8: bool = False
    int8_calib: int = 2

    def __post_init__(self):
        # mode-conditional mutation (tempura_config.py:25-28)
        if self.mode != "predcls":
            self.obj_con_loss = "euc_con"
            self.K = 4
            self.tracking = True
        # "None" sentinels (tempura_config.py:33-38)
        for f in ("rel_mem_compute", "obj_loss_weighting", "rel_loss_weighting"):
            if getattr(self, f) == "None":
                setattr(self, f, None)
        self.mem_feat_lambda = float(self.mem_feat_lambda)
        if self.data_parallel == 0:  # 0 = all local devices
            self.data_parallel = max(torch.cuda.device_count(), 1)

    @classmethod
    def from_args(cls, argv=None) -> "TempuraRunConfig":
        p = ArgumentParser(description="TEMPURA training/eval")
        p.add_argument("--mode", default="predcls")
        p.add_argument("--save_path", default="checkpoint/")
        p.add_argument("--model_path", default=None)
        p.add_argument("--data_path", default="/data/AG/")
        p.add_argument("--output_path", default="output/")
        p.add_argument("--datasize", default="large")
        p.add_argument("--lr", type=float, default=1e-5)
        p.add_argument("--warmup", type=int, default=3)
        p.add_argument("--nepoch", type=int, default=10)
        p.add_argument("--use_ctl_loss", action="store_true")
        p.add_argument("--use_cons_str_loss", action="store_true")
        p.add_argument("--use_cons_sem_loss", action="store_true")
        p.add_argument("-optimizer", default="adamw")
        p.add_argument("-enc_layer", type=int, default=1)
        p.add_argument("-dec_layer", type=int, default=3)
        p.add_argument("-log_iter", type=int, default=100)
        p.add_argument("-obj_head", default="linear")
        p.add_argument("-rel_head", default="gmm")
        p.add_argument("-K", type=int, default=6)
        p.add_argument("-tracking", action="store_true")
        p.add_argument("-rel_mem_compute", default="joint")
        p.add_argument("-obj_mem_compute", action="store_true")
        p.add_argument("-take_obj_mem_feat", action="store_true")
        p.add_argument("-obj_mem_weight_type", default="simple")
        p.add_argument("-rel_mem_weight_type", default="simple")
        p.add_argument("-mem_fusion", default="late")
        p.add_argument("-mem_feat_selection", default="manual")
        p.add_argument("-mem_feat_lambda", default="0.5")
        p.add_argument("-pseudo_thresh", type=int, default=7)
        p.add_argument("-obj_unc", action="store_true")
        p.add_argument("-rel_unc", action="store_true")
        p.add_argument("-obj_loss_weighting", default=None)
        p.add_argument("-rel_loss_weighting", default=None)
        p.add_argument("-mlm", action="store_true")
        p.add_argument("-eos_coef", type=float, default=1.0)
        p.add_argument("-obj_con_loss", default=None)
        p.add_argument("-rel_con_loss", action="store_true")
        p.add_argument("-lambda_con", type=float, default=1.0)
        p.add_argument("-seed", type=int, default=1123)
        p.add_argument("--data_parallel", type=int, default=1)
        p.add_argument("--frame_size", type=int, default=600)
        p.add_argument("--tiny_detector", action="store_true")
        p.add_argument("--bucket_frames", type=int, default=64)
        p.add_argument("--pair_detect", type=int, default=1)
        p.add_argument("--int8", action="store_true")
        p.add_argument("--int8_calib", type=int, default=2)
        args = vars(p.parse_args(argv))
        args["mem_feat_lambda"] = float(args["mem_feat_lambda"])
        return cls(**args)

    def model_config(self) -> TempuraConfig:
        return TempuraConfig(
            mode=self.mode,
            enc_layers=self.enc_layer,
            dec_layers=self.dec_layer,
            obj_head=self.obj_head,
            rel_head=self.rel_head,
            k=self.K,
            tracking=self.tracking,
            obj_mem_compute=self.obj_mem_compute,
            rel_mem_compute=self.rel_mem_compute,
            take_obj_mem_feat=self.take_obj_mem_feat,
            mem_fusion=self.mem_fusion,
            selection=self.mem_feat_selection,
            selection_lambda=self.mem_feat_lambda,
        )

    def loss_flags(self) -> LossFlags:
        return LossFlags(
            mode=self.mode,
            use_ctl_loss=self.use_ctl_loss,
            obj_con_loss=self.obj_con_loss,
            lambda_con=self.lambda_con,
            eos_coef=self.eos_coef,
            use_cons_str_loss=self.use_cons_str_loss,
            use_cons_sem_loss=self.use_cons_sem_loss,
        )
