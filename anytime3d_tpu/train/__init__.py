"""Training layer: jitted train steps over a device mesh, trainer loop,
checkpointing. Reference counterparts: the fit()/GradientTape methods of
src/module/nolbo.py + AE3D.py and the root train_*.py loops.
"""

from anytime3d_tpu.train.state import TrainState, create_train_state, l2_penalty
from anytime3d_tpu.train.step import (
    LossConfig,
    make_eval_step,
    make_train_step,
    make_train_step_dp,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "l2_penalty",
    "LossConfig",
    "make_train_step",
    "make_train_step_dp",
    "make_eval_step",
]
