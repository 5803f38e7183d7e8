"""Core value types the port shares with the reference: the key status
of ``SimCluster``'s write log (``KeyStatus``), and the runtime ``Config``
and ``NodeId`` that the twin's autotuner returns."""

from .config import DEFAULT_MAX_PAYLOAD_SIZE, Config, FailureDetectorConfig, PersistenceConfig
from .identity import Address, NodeId
from .values import KeyStatus, VersionStatusEnum

__all__ = (
    "DEFAULT_MAX_PAYLOAD_SIZE",
    "Address",
    "Config",
    "FailureDetectorConfig",
    "KeyStatus",
    "NodeId",
    "PersistenceConfig",
    "VersionStatusEnum",
)
