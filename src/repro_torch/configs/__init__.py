from repro_torch.configs.base import (ArchConfig, SHAPES, ShapeSpec,
                                      cell_applicable, input_specs,
                                      reduce_for_smoke)
from repro_torch.configs.registry import ARCHS, get

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec", "cell_applicable",
           "input_specs", "reduce_for_smoke", "ARCHS", "get"]
