from .attresunet import AttResUNet
from .dncnn import DnCNN
from .knet import KernelNet
from .virnet import (ARCH_PRESETS, LOG_MAX, LOG_MIN, VIRNet, VIRNetSR,
                     build_model)

__all__ = ["ARCH_PRESETS", "AttResUNet", "DnCNN", "KernelNet", "LOG_MAX",
           "LOG_MIN", "VIRNet", "VIRNetSR", "build_model"]
