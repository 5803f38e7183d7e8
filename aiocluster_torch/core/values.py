"""The lifecycle status of a versioned key (the port's own copy of the
reference's ``core/values.py::VersionStatusEnum``; only the status,
which ``SimCluster``'s write log carries):

- ``SET``: live value.
- ``DELETED``: tombstone (value cleared).
- ``DELETE_AFTER_TTL``: like SET but scheduled to become eligible for GC
  after the grace period (a soft TTL).
"""

from __future__ import annotations

from enum import IntEnum


class VersionStatusEnum(IntEnum):
    """Lifecycle status of a versioned key (the reference's values, which
    match its wire enum)."""

    SET = 0
    DELETED = 1
    DELETE_AFTER_TTL = 2


# Shorter idiomatic alias used internally.
KeyStatus = VersionStatusEnum
