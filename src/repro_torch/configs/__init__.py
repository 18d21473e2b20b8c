from repro_torch.configs.base import (ARCH_IDS, SHAPES, SUBQUADRATIC, ModelConfig,
                                ShapeConfig, all_cells, cell_applicable, get_config)

__all__ = ["ARCH_IDS", "SHAPES", "SUBQUADRATIC", "ModelConfig", "ShapeConfig",
           "all_cells", "cell_applicable", "get_config"]
