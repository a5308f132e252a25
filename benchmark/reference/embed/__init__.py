"""The plain reference of the PointGroupEmbed family (the paper's Setting
I): its model, its strategy-7 clustering (mean shift on the embedding),
its losses and its train step, in plain PyTorch in f32 with TF32 off. A
frozen copy of the port's embed paths beside :mod:`..plain`, whose
unchanged modules it takes (the UNet, the maps, mean shift's plain loop,
``pack_by_sample``, the proposal table, Adam); it imports nothing of the
port."""
from .model import (
    EmbedConfig,
    PointGroupEmbedNet,
    build_proposals,
    embed_config_from_yaml,
    panoptic_losses,
)
from .step import make_train_step, panoptic_forward, run_steps

__all__ = [
    "EmbedConfig", "PointGroupEmbedNet", "build_proposals", "embed_config_from_yaml",
    "make_train_step", "panoptic_forward", "panoptic_losses", "run_steps",
]
