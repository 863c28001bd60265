"""Messaging, error taxonomy, and verbosity levels.

Equivalent of the reference's central message module
(message.h:12-53 enums; message():  message.c:27-126): a uniform
``TYPE [file::function(line)]: text`` stderr format with canned strings
for the common error classes, callable as ``return message(...)`` /
``raise MulticlustError(...)``.  The caller's file/function/line are
recovered by frame introspection instead of ``__FILE__``/``__func__``
macros.

The 8-level verbosity enum (message.h:45-53) gates every progress/trace
surface: runtime/observe.py trace lines, the multi-start per-init report,
and cli verbosity handling all compare against these levels.
"""

from __future__ import annotations

import os
import sys
from enum import IntEnum
from typing import IO, Optional


class MsgType(IntEnum):
    """Message urgency (message.h:12-17)."""

    NO_MSG = 0
    INFO = 1
    DEBUG = 2
    WARNING = 3
    ERROR = 4


class Err(IntEnum):
    """Error taxonomy (message.h:21-41)."""

    NO_ERROR = 0
    CUSTOM_ERROR = 1
    NO_DATA = 2
    MEMORY_ALLOCATION = 3
    FILE_NOT_FOUND = 4
    FILE_OPEN_ERROR = 5
    END_OF_FILE = 6
    FILE_FORMAT_ERROR = 7
    INVALID_CMDLINE = 8
    INVALID_CMD_OPTION = 9
    INVALID_CMD_ARGUMENT = 10
    INVALID_USER_SETUP = 11
    INTERNAL_MISMATCH = 12
    INTERNAL_ERROR = 13
    OUT_OF_TIME = 14
    MEMORY_USAGE_LIMIT = 15


class Verbosity(IntEnum):
    """Verbosity levels (message.h:45-53)."""

    ABSOLUTE_SILENCE = 0  # only output through files
    SILENT = 1            # final output only
    QUIET = 2
    MINIMAL = 3
    RESTRAINED = 4
    TALKATIVE = 5
    VERBOSE = 6
    DEBUG = 7


_TYPE_LABEL = {
    MsgType.INFO: "INFO",
    MsgType.DEBUG: "DEBUG",
    MsgType.WARNING: "WARNING",
    MsgType.ERROR: "ERROR",
}


def _canned(msg_id: int, text: str) -> str:
    """Default strings per error class (message.c:40-119)."""
    e = Err(msg_id)
    if e == Err.MEMORY_ALLOCATION:
        return f"could not allocate {text}" if text \
            else "memory allocation error"
    if e == Err.INVALID_CMD_OPTION:
        return f"unrecognized command option: {text}" if text \
            else "unrecognized command option"
    if e == Err.INVALID_CMD_ARGUMENT:
        return f"invalid argument to command option: {text}" if text \
            else "invalid argument to command option"
    if e == Err.INVALID_CMDLINE:
        return f"[invalid command line] {text}"
    if e == Err.INVALID_USER_SETUP:
        return f"[invalid user choice] {text}"
    if e == Err.FILE_OPEN_ERROR:
        return f'could not open file "{text}"'
    if e == Err.FILE_NOT_FOUND:
        return f'file "{text}" not found'
    if e == Err.FILE_FORMAT_ERROR:
        return f"invalid file format: {text}" if text \
            else "invalid file format"
    if e == Err.END_OF_FILE:
        return f'unexpected end of file in file "{text}"'
    if e == Err.INTERNAL_MISMATCH:
        return f"[internal mismatch] {text}"
    if e == Err.OUT_OF_TIME:
        # text carries the limit in seconds (CHECK_TIME, message.h:55-63)
        try:
            nsec = int(float(text))
        except (TypeError, ValueError):
            return "out of time"
        return "out of time (limit %02d:%02dm)" % (nsec // 3600,
                                                   (nsec % 3600) // 60)
    if e == Err.MEMORY_USAGE_LIMIT:
        return f"exceed memory limit: {text}" if text \
            else "exceed memory limit"
    return text


def message(fp: Optional[IO], msg_type: MsgType, msg_id: int,
            text: str = "", *, _depth: int = 1) -> int:
    """Write a uniformly formatted message; returns ``msg_id`` so callers
    can ``return message(...)`` (message.c:27-126).  ``fp=None`` formats
    without writing (used by MulticlustError.__str__)."""
    frame = sys._getframe(_depth)
    where = "%s::%s(%d)" % (os.path.basename(frame.f_code.co_filename),
                            frame.f_code.co_name, frame.f_lineno)
    body = text if msg_id == Err.NO_ERROR else _canned(msg_id, text)
    line = "%s [%s]: %s\n" % (_TYPE_LABEL.get(MsgType(msg_type), "ERROR"),
                              where, body)
    if fp is not None:
        fp.write(line)
    return int(msg_id)


def mmessage(msg_type: MsgType, msg_id: int, text: str = "") -> int:
    """``message`` to stderr with the caller's location (message.h:85)."""
    return message(sys.stderr, msg_type, msg_id, text, _depth=2)


class MulticlustError(Exception):
    """An error carrying its taxonomy code; bubbles to cli.main which
    reports it via ``message`` and exits with the code (the reference's
    error codes bubble to main the same way, multiclust.c:157-164)."""

    def __init__(self, err: Err, text: str = ""):
        self.err = Err(err)
        self.text = text
        super().__init__(_canned(err, text) if err != Err.NO_ERROR else text)
