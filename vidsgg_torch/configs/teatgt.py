"""TEAT-GT run configuration (CLI surface).

The port's own copy of ``vidsgg/configs/teatgt.py``: flag names, defaults
and the mode-derived overrides of the reference's
tools/utils/teatgt_config.py (:11-14). ``model_config()`` gives the port's
:class:`~vidsgg_torch.models.teatgt.TeatGTConfig`; the loss flags
(``loss_flags()``) come with the port's training loop.
"""

from __future__ import annotations

import dataclasses
from argparse import ArgumentParser

import torch

from vidsgg_torch.models.graph_build import ClipCaps
from vidsgg_torch.models.teatgt import TeatGTConfig


@dataclasses.dataclass
class TeatGTRunConfig:
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
    log_iter: int = 100
    tracking: bool = False
    num_atoms: int = 1168
    num_edges: int = 1
    num_output: int = 26
    lap_node_id: bool = True
    lap_node_id_k: int = 50
    lap_node_id_sign_flip: bool = True
    lap_node_id_eig_dropout: float = 0.2
    rand_node_id: bool = False
    rand_node_id_dim: int = 50
    orf_node_id: bool = False
    orf_node_id_dim: int = 50
    type_id: bool = True
    stochastic_depth: bool = False
    encoder_embed_dim: int = 768
    encoder_layers: int = 12
    encoder_attention_heads: int = 32
    encoder_ffn_embed_dim: int = 768
    return_attention: bool = True
    seed: int = 1123
    # videos per data-parallel group (1 = single device, 0 = all local
    # devices)
    data_parallel: int = 1
    # rehearsal/dev hooks (see configs/tempura.py)
    frame_size: int = 600
    tiny_detector: bool = False
    bucket_frames: int = 64
    # sgdet eval: videos per detect dispatch (see configs/tempura.py)
    pair_detect: int = 1
    # serving-only int8 PTQ of the detector (see configs/tempura.py)
    int8: bool = False
    int8_calib: int = 2

    def __post_init__(self):
        if self.mode != "predcls":  # teatgt_config.py:11-14
            self.tracking = True
            self.encoder_layers = 6
            self.encoder_attention_heads = 16
        if self.data_parallel == 0:  # 0 = all local devices
            self.data_parallel = max(torch.cuda.device_count(), 1)

    @classmethod
    def from_args(cls, argv=None) -> "TeatGTRunConfig":
        p = ArgumentParser(description="TEAT-GT training/eval")
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
        p.add_argument("--log_iter", type=int, default=100)
        p.add_argument("--tracking", action="store_true")
        p.add_argument("--num_atoms", type=int, default=1168)
        p.add_argument("--num_edges", type=int, default=1)
        p.add_argument("--num_output", type=int, default=26)
        p.add_argument("--lap_node_id", action="store_true", default=True)
        p.add_argument("--lap_node_id_k", type=int, default=50)
        p.add_argument("--lap_node_id_sign_flip", action="store_true", default=True)
        p.add_argument("--lap_node_id_eig_dropout", type=float, default=0.2)
        p.add_argument("--rand_node_id", action="store_true")
        p.add_argument("--rand_node_id_dim", type=int, default=50)
        p.add_argument("--orf_node_id", action="store_true")
        p.add_argument("--orf_node_id_dim", type=int, default=50)
        p.add_argument("--type_id", action="store_true", default=True)
        p.add_argument("--stochastic_depth", action="store_true")
        p.add_argument("--encoder_embed_dim", type=int, default=768)
        p.add_argument("--encoder_layers", type=int, default=12)
        p.add_argument("--encoder_attention_heads", type=int, default=32)
        p.add_argument("--encoder_ffn_embed_dim", type=int, default=768)
        p.add_argument("--return_attention", action="store_true", default=True)
        p.add_argument("--seed", type=int, default=1123)
        p.add_argument("--data_parallel", type=int, default=1)
        p.add_argument("--frame_size", type=int, default=600)
        p.add_argument("--tiny_detector", action="store_true")
        p.add_argument("--bucket_frames", type=int, default=64)
        p.add_argument("--pair_detect", type=int, default=1)
        p.add_argument("--int8", action="store_true")
        p.add_argument("--int8_calib", type=int, default=2)
        return cls(**vars(p.parse_args(argv)))

    def model_config(self, caps: ClipCaps | None = None) -> TeatGTConfig:
        return TeatGTConfig(
            mode=self.mode,
            tracking=self.tracking,
            encoder_layers=self.encoder_layers,
            encoder_attention_heads=self.encoder_attention_heads,
            encoder_embed_dim=self.encoder_embed_dim,
            encoder_ffn_embed_dim=self.encoder_ffn_embed_dim,
            num_atoms=self.num_atoms,
            num_output=self.num_output,
            lap_node_id_k=self.lap_node_id_k,
            node_id_mode=(
                "rand" if self.rand_node_id
                else "orf" if self.orf_node_id else "lap"
            ),
            caps=caps or ClipCaps(),
        )
