"""Model and AFL configurations of the port: copies of `repro.configs`
(plain dataclasses, the ten architectures and the registry)."""
from repro_torch.configs.base import (AFLConfig, INPUT_SHAPES, InputShape,
                                      ModelConfig)
