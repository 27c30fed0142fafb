"""Neural-network layers of the port."""

from .attention import (  # noqa: F401
    Attention,
    CrossTransformer,
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
from .dropout import Dropout, dropout  # noqa: F401
from .blocks import (  # noqa: F401
    SNet,
    conv_bn_act,
    global_avg_pool,
    tokens_from_volume,
)
from .grl import revgrad  # noqa: F401
