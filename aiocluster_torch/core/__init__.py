"""Core value types the simulator's key/value surface shares with the
reference (``KeyStatus``)."""

from .values import KeyStatus, VersionStatusEnum

__all__ = ("KeyStatus", "VersionStatusEnum")
