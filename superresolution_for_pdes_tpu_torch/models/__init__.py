"""Model zoo: the attention U-Net, the residual CNN, SwinIR, HAT, Restormer, the regime
router and the weight converters."""

from superresolution_for_pdes_tpu_torch.models.unet import (  # noqa: F401
    AttentionGate,
    AttentionUNet,
    ConvBlock,
    count_parameters,
)
from superresolution_for_pdes_tpu_torch.models.resnet import PDEResNet  # noqa: F401
from superresolution_for_pdes_tpu_torch.models.swinir import SwinIR  # noqa: F401
from superresolution_for_pdes_tpu_torch.models.hat import HAT  # noqa: F401
from superresolution_for_pdes_tpu_torch.models.restormer import Restormer  # noqa: F401
from superresolution_for_pdes_tpu_torch.models.registry import (  # noqa: F401
    available_models,
    build_model,
)
