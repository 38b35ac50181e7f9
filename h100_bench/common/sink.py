"""Where a job's output goes: a pipe that the program opens as
``/dev/fd/<n>`` and writes through its own ``OutputWriter``, read by a
process of the harness's own (``sink_reader.py``), so that the reader takes
no turn at the program's interpreter lock. Nothing reaches the disk.

The first job on an input keeps its whole stream in an anonymous memory
file (``memfd``) that both processes map; every later job on that input is
compared with it byte for byte as it arrives. After the window the kept
streams are judged against the reference, so every job's whole output is
judged. The reader costs the same on both sides of any comparison.
"""

from __future__ import annotations

import fcntl
import json
import mmap
import os
import socket
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np

READER = Path(__file__).with_name("sink_reader.py")
F_SETPIPE_SZ = 1031  # fcntl.F_SETPIPE_SZ (Linux), absent from older Pythons


@dataclass
class Output:
    nbytes: int
    # None: this job's stream was kept; else whether it equalled the kept one
    same: Optional[bool]
    overflow: bool  # the stream ran past the room an output can need


class Sink:
    def __init__(self) -> None:
        self.kept: Dict[int, np.ndarray] = {}
        self._files: Dict[int, tuple] = {}  # key -> (memfd, room, its mapping)
        self._key: Optional[int] = None
        self._w: Optional[int] = None
        ours, theirs = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        self._proc = subprocess.Popen([sys.executable, str(READER), str(theirs.fileno())],
                                      pass_fds=[theirs.fileno()], stdin=subprocess.DEVNULL)
        theirs.close()
        self._sock = ours
        self._replies = ours.makefile("r")

    def _send(self, msg: dict, fds=()) -> None:
        socket.send_fds(self._sock, [json.dumps(msg).encode() + b"\n"], list(fds))

    def _reply(self) -> dict:
        line = self._replies.readline()
        if not line:
            raise RuntimeError(f"the sink's reader ended (exit {self._proc.poll()})")
        reply = json.loads(line)
        if "error" in reply:
            raise RuntimeError(f"the sink's reader failed: {reply['error']}")
        return reply

    def _file(self, key: int, room: int, populate: bool) -> int:
        if key not in self._files or self._files[key][1] != room:
            fd = os.memfd_create(f"h100_bench_kept_{key}")
            os.ftruncate(fd, max(room, 1))
            self._files[key] = (fd, room, mmap.mmap(fd, max(room, 1)))
            self._send({"op": "map", "key": key, "room": room, "populate": populate}, [fd])
            self._reply()
        return self._files[key][0]

    def prepare(self, key: int, room: int) -> None:
        """Give the first job on input ``key`` a kept file of ``room`` bytes
        whose pages are already in memory, so that the window's first job
        does not pay for faulting them in."""
        self._file(key, room, populate=True)

    def start(self, key: int, room: int) -> str:
        """Open the pipe of one job on input ``key``, whose output needs at
        most ``room`` bytes; returns the path the program writes to."""
        if key not in self.kept:
            self._file(key, room, populate=False)
        r, w = os.pipe()
        try:
            fcntl.fcntl(w, F_SETPIPE_SZ, 1 << 20)
        except OSError:
            pass  # the system's limit on a pipe's size: the default serves
        try:
            if key in self.kept:
                self._send({"op": "compare", "key": key, "n": int(self.kept[key].shape[0])}, [r])
            else:
                self._send({"op": "keep", "key": key}, [r])
        finally:
            os.close(r)
        self._key, self._w = key, w
        return f"/dev/fd/{w}"

    def finish(self) -> Output:
        """Close the harness's end of the pipe and wait for the stream's end
        (the program closed its own end when the job returned)."""
        os.close(self._w)
        reply = self._reply()
        key = self._key
        if reply["same"] is None:
            view = self._files[key][2]
            self.kept[key] = np.frombuffer(view, np.uint8)[: reply["n"]]
        return Output(reply["n"], reply["same"], reply["overflow"])

    def forget(self, key: int) -> None:
        """Drop input ``key``'s kept stream (the warm-up's)."""
        self.kept.pop(key, None)
        entry = self._files.pop(key, None)
        if entry is not None:
            self._send({"op": "unmap", "key": key})
            self._reply()
            os.close(entry[0])

    def close(self) -> None:
        """Stop the reader process and wait for its end. The kept streams
        stay readable."""
        if self._proc.poll() is None:
            try:
                self._sock.sendall(b'{"op": "stop"}\n')
            except OSError:
                pass
            try:
                self._proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
        self._replies.close()
        self._sock.close()
        for fd, _, _ in self._files.values():
            os.close(fd)
        self._files = {}  # the kept arrays hold their mappings
