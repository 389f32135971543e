"""The node of the port: config files, the composition root and its CLI
(``python -m hotstuff_tpu_torch.node``), and the benchmark client
(``hotstuff_tpu_torch.node.client``). Port of ``hotstuff_tpu/node``."""

from .config import Committee, ConfigError, Parameters, Secret
from .node import Node

__all__ = ["Node", "Committee", "Parameters", "Secret", "ConfigError"]
