"""Model and operator configuration.

The same fields and defaults as `t2onet_tpu.config` (a test holds the two
equal). The port keeps its own copy so that importing it never loads the
JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

FIVEK_VOCAB_SIZE = 918          # FiveK session-1 request vocabulary
GIER_VOCAB_SIZE = 3046          # GIER session-3 request vocabulary


@dataclasses.dataclass(frozen=True)
class OperatorConfig:
    """Parameter ranges of the editing operators."""

    exposure_range: float = 3.5
    sharpness_range: float = 1.5
    brightness_range: float = 2.0
    curve_steps: int = 8
    tone_curve_range: Tuple[float, float] = (0.5, 2.0)
    color_curve_range: Tuple[float, float] = (0.90, 1.10)
    saturation_range: Tuple[float, float] = (-0.2, 0.8)
    max_param: int = 24


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Seq2seq actor architecture."""

    encoder_max_len: int = 17
    decoder_max_len: int = 5
    hidden_size: int = 256          # per-direction LSTM hidden
    word_vec_dim: int = 300
    n_layers: int = 2
    bidirectional: bool = True
    use_attention: bool = True
    operator_fc_dim: int = 512      # per-op parameter head fc1 width
    resnet_depth: int = 18
    vis_feat_dim: int = 512
    resnet_widths: Tuple[int, int, int, int] = (64, 128, 256, 512)
    vis_bf16: bool = False
    input_dropout_p: float = 0.0
    dropout_p: float = 0.0
    fix_input_embedding: bool = False
    discrete_param: bool = False
    discrete_step: int = 10

    @classmethod
    def tiny(cls, **overrides) -> "ModelConfig":
        """Every architectural feature of the default at narrow widths."""
        kw = dict(hidden_size=16, word_vec_dim=16, operator_fc_dim=16,
                  vis_feat_dim=32, resnet_widths=(8, 8, 16, 16))
        kw.update(overrides)
        return cls(**kw)

    attend_batch_max: bool = False
    null_id: int = 0
    start_id: int = 1
    end_id: int = 2
    unk_id: int = 3
    n_spec_token: int = 4
    op_vocab_size: int = 11

    @property
    def decoder_hidden(self) -> int:
        """Decoder hidden = 2 * encoder hidden for the bi-encoder."""
        return self.hidden_size * (2 if self.bidirectional else 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (batch 64, 10k iterations, Adam lr 1e-3).
    lam1 / lam2 are declared but unused, as in the JAX package: the
    trainer's losses are a plain op_loss + param_loss and a plain L1."""

    batch_size: int = 64
    num_iters: int = 10_000
    learning_rate: float = 1e-3
    explore_prob: float = 0.05
    entropy_factor: float = 0.05
    print_every: int = 100
    checkpoint_every: int = 1000
    train_img_size: int = 128
    seed: int = 10
    lam1: float = 1.0
    lam2: float = 5.0


@dataclasses.dataclass(frozen=True)
class Config:
    operators: OperatorConfig = OperatorConfig()
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    dataset: str = "FiveK"
    session: int = 1
    vocab_size: int = FIVEK_VOCAB_SIZE

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def fivek_config(**overrides) -> Config:
    """The FiveK session-1 configuration, with `overrides` replaced."""
    return dataclasses.replace(Config(), **overrides)


def gier_config(**overrides) -> Config:
    """The GIER session-3 configuration (3,046 request tokens)."""
    base = Config(dataset="GIER", session=3, vocab_size=GIER_VOCAB_SIZE)
    return dataclasses.replace(base, **overrides)
