from .attention import (as_kv_padding_mask,  # noqa: F401
                        scaled_dot_product_attention)
from .common import dropout  # noqa: F401
from .loss import cross_entropy  # noqa: F401
