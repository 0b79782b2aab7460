"""Status/error model.

Mirrors the reference's seven status codes (include/jpeggpu/jpeggpu.h:38-52)
as a Python exception hierarchy.
"""

from __future__ import annotations

import enum


class Status(enum.Enum):
    SUCCESS = 0
    INVALID_ARGUMENT = 1
    INVALID_JPEG = 2
    INTERNAL_ERROR = 3
    NOT_SUPPORTED = 4
    OUT_OF_HOST_MEMORY = 5
    INCOMPLETE_BITSTREAM = 6


_STATUS_STRINGS = {
    Status.SUCCESS: "success",
    Status.INVALID_ARGUMENT: "illegal argument provided to a function",
    Status.INVALID_JPEG: "JPEG stream is not compatible with the specification",
    Status.INTERNAL_ERROR: "an error inside the library occurred",
    Status.NOT_SUPPORTED: "JPEG stream is valid but not supported",
    Status.OUT_OF_HOST_MEMORY: "the system is out of host memory",
    Status.INCOMPLETE_BITSTREAM: "JPEG stream is invalid, likely incomplete",
}


def get_status_string(status: Status) -> str:
    return _STATUS_STRINGS[status]


class JpegError(Exception):
    """Base class; carries a :class:`Status`."""

    status = Status.INTERNAL_ERROR

    def __init__(self, message: str = ""):
        super().__init__(message or get_status_string(self.status))


class InvalidArgument(JpegError):
    status = Status.INVALID_ARGUMENT


class InvalidJpeg(JpegError):
    status = Status.INVALID_JPEG


class InternalError(JpegError):
    status = Status.INTERNAL_ERROR


class NotSupported(JpegError):
    status = Status.NOT_SUPPORTED


class OutOfHostMemory(JpegError):
    status = Status.OUT_OF_HOST_MEMORY


class IncompleteBitstream(JpegError):
    status = Status.INCOMPLETE_BITSTREAM
