"""Minimal ctypes binding to Linux inotify for the cross-process watchers.

The container ships no inotify Python package, so the binding talks to
libc directly: ``inotify_init1`` / ``inotify_add_watch`` / ``read``.  The
:class:`~repro_torch.storage.object_store._PollWatcher` uses it (when available)
to block on real filesystem events instead of exponential-backoff polling —
zero wakeups between events, sub-millisecond wake on an append from another
process.  On non-Linux platforms, or if libc refuses, ``Inotify.available()``
is False and the watcher keeps the portable backoff poll.

Only what the watchers need is bound: watches are added on *directories*
(per inotify(7), a directory watch reports events for the files inside it,
which also survives the atomic-rename pattern every writer here uses —
a ``rename`` onto a watched directory's entry raises ``IN_MOVED_TO``
where a watch on the replaced file itself would have died with it).
"""

from __future__ import annotations

import ctypes
import os
import struct
import sys
import threading
from typing import List, Optional, Tuple

# Event masks (linux/inotify.h)
IN_MODIFY = 0x00000002
IN_ATTRIB = 0x00000004
IN_CLOSE_WRITE = 0x00000008
IN_MOVED_FROM = 0x00000040
IN_MOVED_TO = 0x00000080
IN_CREATE = 0x00000100
IN_DELETE = 0x00000200

# Everything a writer can do to a log/seq/object file in a watched dir.
WATCH_MASK = (
    IN_MODIFY
    | IN_ATTRIB
    | IN_CLOSE_WRITE
    | IN_MOVED_FROM
    | IN_MOVED_TO
    | IN_CREATE
    | IN_DELETE
)

_IN_NONBLOCK = 0o4000  # O_NONBLOCK
_IN_CLOEXEC = 0o2000000  # O_CLOEXEC

_EVENT_HDR = struct.Struct("iIII")  # wd, mask, cookie, name length

_libc = None
_libc_guard = threading.Lock()
_probe_result: Optional[bool] = None


def _get_libc():
    global _libc
    with _libc_guard:
        if _libc is None:
            _libc = ctypes.CDLL(None, use_errno=True)
        return _libc


class Inotify:
    """One inotify instance (non-blocking fd; poll/select it, then drain
    with :meth:`read_events`)."""

    def __init__(self) -> None:
        libc = _get_libc()
        fd = libc.inotify_init1(_IN_NONBLOCK | _IN_CLOEXEC)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._fd = fd
        self._libc = libc

    @staticmethod
    def available() -> bool:
        """Can this platform serve inotify?  Probed once (cheap init/close)."""
        global _probe_result
        if _probe_result is None:
            if not sys.platform.startswith("linux"):
                _probe_result = False
            else:
                try:
                    Inotify().close()
                    _probe_result = True
                except Exception:
                    _probe_result = False
        return _probe_result

    def fileno(self) -> int:
        return self._fd

    def add_watch(self, path: str, mask: int = WATCH_MASK) -> int:
        wd = self._libc.inotify_add_watch(self._fd, os.fsencode(path), mask)
        if wd < 0:
            raise OSError(ctypes.get_errno(), f"inotify_add_watch({path!r}) failed")
        return wd

    def read_events(self) -> List[Tuple[int, int, str]]:
        """Drain pending events: ``[(wd, mask, name), ...]``.  Non-blocking —
        returns [] when the kernel queue is empty."""
        out: List[Tuple[int, int, str]] = []
        while True:
            try:
                buf = os.read(self._fd, 65536)
            except BlockingIOError:
                return out
            except OSError:
                return out
            off = 0
            while off + _EVENT_HDR.size <= len(buf):
                wd, mask, _cookie, nlen = _EVENT_HDR.unpack_from(buf, off)
                off += _EVENT_HDR.size
                name = buf[off : off + nlen].split(b"\0", 1)[0].decode(
                    "utf-8", "surrogateescape"
                )
                off += nlen
                out.append((wd, mask, name))

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
