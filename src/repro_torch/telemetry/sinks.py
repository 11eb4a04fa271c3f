"""Pluggable telemetry sinks and the ``Telemetry`` recorder that fans
events out to them.

Sinks are duck-typed: anything with ``emit(event: dict)`` (and
optionally ``close()``) works. Provided:

* :class:`JsonlSink` — one JSON object per line, flushed per event, so
  a crashed run still leaves every emitted round on disk;
* :class:`RingBufferSink` — bounded in-memory buffer (``deque`` with
  ``maxlen``) for interactive inspection and tests;
* :class:`ListSink` — unbounded capture (tests, the report renderer).

``Telemetry`` is a context manager: ``__exit__`` closes every sink even
when the body raised, so the JSONL tail is never lost to an exception
mid-run.
"""
from __future__ import annotations

from collections import deque
from pathlib import Path
from typing import Any, Dict, IO, List, Optional, Union

from repro_torch.telemetry.schema import encode


class JsonlSink:
    """Append events to a JSONL file (or any writable text handle),
    flushing after every line."""

    def __init__(self, path: Union[str, Path, IO[str]]):
        if hasattr(path, "write"):
            self._fh: Optional[IO[str]] = path     # caller-owned handle
            self._owns = False
        else:
            self.path = Path(path)
            self._fh = self.path.open("w")
            self._owns = True

    def emit(self, event: Dict[str, Any]) -> None:
        if self._fh is None:
            raise ValueError("JsonlSink is closed")
        self._fh.write(encode(event) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None and self._owns:
            self._fh.close()
        self._fh = None

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class RingBufferSink:
    """Keep the last ``capacity`` events in memory."""

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._buf: deque = deque(maxlen=capacity)

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    @property
    def events(self) -> List[Dict[str, Any]]:
        return list(self._buf)

    def emit(self, event: Dict[str, Any]) -> None:
        self._buf.append(event)

    def close(self) -> None:
        pass


class ListSink:
    """Capture every event (unbounded — tests and renderers)."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


class Telemetry:
    """Multi-sink event recorder. ``emit`` fans out in sink order;
    ``close`` closes every sink (errors in one do not skip the rest)."""

    def __init__(self, *sinks: Any):
        self.sinks = list(sinks)

    @classmethod
    def to_jsonl(cls, path: Union[str, Path]) -> "Telemetry":
        return cls(JsonlSink(path))

    def emit(self, event: Dict[str, Any]) -> None:
        for s in self.sinks:
            s.emit(event)

    def close(self) -> None:
        err: Optional[BaseException] = None
        for s in self.sinks:
            try:
                close = getattr(s, "close", None)
                if close is not None:
                    close()
            except BaseException as e:   # keep closing the rest
                err = err or e
        if err is not None:
            raise err

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
