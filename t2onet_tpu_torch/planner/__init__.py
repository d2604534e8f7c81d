"""Operation planning: pseudo ground-truth action sequences for the
supervised phase (counterpart of `t2onet_tpu.planner`). Every
(beam x op x restart) parameter fit of a beam-search step is one batched
Adam optimisation through the differentiable operators."""

from t2onet_tpu_torch.planner.fit import fit_op_params, init_candidates  # noqa: F401
from t2onet_tpu_torch.planner.beam import beam_search  # noqa: F401
