from .attresunet import AttResUNet
from .dncnn import DnCNN
from .virnet import ARCH_PRESETS, LOG_MAX, LOG_MIN, VIRNet, build_model

__all__ = ["ARCH_PRESETS", "AttResUNet", "DnCNN", "LOG_MAX", "LOG_MIN",
           "VIRNet", "build_model"]
