"""Port of ``cuking_tpu/utils/status.py`` (a copy; same classes and messages).

Typed error hierarchy mirroring the reference's absl::Status codes.

The reference propagates absl::Status across its host pipeline
(cuking.cu:58-98) and fails fast in main (cuking.cu:889-893).  We use typed
exceptions with the same code names so CLI error messages and exit behavior
match: InvalidArgument for flag validation (cuking.cu:436-465),
FailedPrecondition for input/schema problems (cuking.cu:478-486, 542-543,
586-590, 698-701), ResourceExhausted for result-buffer overflow
(cuking.cu:747-751).
"""

from __future__ import annotations


class CukingError(Exception):
    """Base class for all cuking_tpu errors."""

    code = "UNKNOWN"

    def __str__(self) -> str:  # e.g. "INVALID_ARGUMENT: No input URI specified"
        return f"{self.code}: {super().__str__()}"


class InvalidArgumentError(CukingError):
    code = "INVALID_ARGUMENT"


class FailedPreconditionError(CukingError):
    code = "FAILED_PRECONDITION"


class ResourceExhaustedError(CukingError):
    code = "RESOURCE_EXHAUSTED"


class UnknownError(CukingError):
    code = "UNKNOWN"
