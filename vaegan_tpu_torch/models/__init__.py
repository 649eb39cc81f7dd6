from vaegan_tpu_torch.models.blocks import ResBlockVAE
from vaegan_tpu_torch.models.layers import BatchNorm, Conv2D, Dropout, leaky_relu
from vaegan_tpu_torch.models.networks import (
    Decoder,
    Encoder,
    SpatialVAECodeProcessor,
    UnsupervisedGeneratorNetwork,
)

__all__ = [
    "BatchNorm", "Conv2D", "Decoder", "Dropout", "Encoder", "ResBlockVAE",
    "SpatialVAECodeProcessor", "UnsupervisedGeneratorNetwork", "leaky_relu",
]
