"""Neural-network layers of the port (eval mode)."""

from .attention import (  # noqa: F401
    Attention,
    CrossTransformerModAvg,
    FeedForward,
    LayerNorm,
    Linear,
    Transformer,
)
from .batchnorm import (  # noqa: F401
    BatchNormMasked,
    ManualBN,
    bn_affine_reference,
)
from .blocks import (  # noqa: F401
    SNet,
    conv_bn_act,
    global_avg_pool,
    tokens_from_volume,
)
from .grl import revgrad  # noqa: F401
