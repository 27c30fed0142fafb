"""Neural-network layers of the port."""

from .attention import (  # noqa: F401
    Attention,
    CrossTransformer,
    CrossTransformerModAvg,
    FeedForward,
    LayerNorm,
    Linear,
    PositionalEncoding1D,
    Transformer,
)
from .batchnorm import (  # noqa: F401
    BatchNormMasked,
    ManualBN,
    bn_affine_reference,
)
from .dropout import Dropout, dropout  # noqa: F401
from .blocks import (  # noqa: F401
    SFCN,
    SNet,
    conv_bn_act,
    global_avg_pool,
    tokens_from_volume,
)
from .grl import revgrad  # noqa: F401
from .losses import (  # noqa: F401
    adversarial_loss,
    cross_entropy,
    fa_loss,
    supcon_loss,
)
