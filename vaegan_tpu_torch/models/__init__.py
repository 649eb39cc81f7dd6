from vaegan_tpu_torch.models.blocks import ResBlockDiscriminator, ResBlockVAE
from vaegan_tpu_torch.models.layers import (
    BatchNorm,
    Conv2D,
    Dropout,
    Linear,
    inject_masks,
    leaky_relu,
)
from vaegan_tpu_torch.models.networks import (
    Decoder,
    Discriminator,
    Encoder,
    SpatialVAECodeProcessor,
    UnsupervisedGeneratorNetwork,
    critic_pool_shape,
)

__all__ = [
    "BatchNorm", "Conv2D", "Decoder", "Discriminator", "Dropout", "Encoder", "Linear",
    "ResBlockDiscriminator", "ResBlockVAE", "SpatialVAECodeProcessor",
    "UnsupervisedGeneratorNetwork", "critic_pool_shape", "inject_masks", "leaky_relu",
]
