"""Operator math, the executor bank and the chain kernel.

Images are NCHW (B, 3, H, W) float32 in [0, 1], as in `t2onet_tpu.ops`,
whose public names this package exports too.
"""

from t2onet_tpu_torch.ops.color import (  # noqa: F401
    hsv_to_rgb,
    lerp,
    rgb_to_hsv,
    rgb2lum,
    tanh01,
    tanh_range,
)
from t2onet_tpu_torch.ops.operators import (  # noqa: F401
    OP_FNS,
    OP_NAMES,
    PARAM_COUNTS,
    apply_op_by_index,
    brightness,
    color_curve,
    contrast,
    exposure,
    bnw,
    blur,
    hue,
    white_balance,
    inpaint,
    mask_blend,
    saturation,
    sharpness,
    tone_curve,
    white,
)
from t2onet_tpu_torch.ops.bank import (  # noqa: F401
    N_OPS,
    execute_bank,
    execute_onehot,
    squash_params,
)
