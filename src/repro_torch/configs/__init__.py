"""The architecture and shape registry: a copy of the JAX package's
``configs`` (pure data, no JAX in it), so that the port names the same
models and sizes without importing it."""
from repro_torch.configs.base import (ArchConfig, MoEConfig, ShapeConfig,
                                      SHAPES, get_config, list_archs,
                                      register)

__all__ = ["ArchConfig", "MoEConfig", "ShapeConfig", "SHAPES",
           "get_config", "list_archs", "register"]
