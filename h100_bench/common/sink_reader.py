"""The sink's reader, a process of its own that ``sink.py`` starts once a
run, so that reading the program's output takes no turn at the program's
interpreter lock:

    python3 sink_reader.py <fd of a Unix socket>

Each message is one JSON line on the socket, its file descriptors passed
with it; the reader answers each but ``keep`` and ``compare`` at once, and
those at the stream's end, with one JSON line:

- ``map`` {key, room, populate} + [memfd]: map the kept file of input
  ``key`` (``populate``: fault its pages in now);
- ``unmap`` {key};
- ``keep`` {key} + [a pipe's read end]: read the stream into the file of
  ``key``: {n, same: null, overflow};
- ``compare`` {key, n} + [a pipe's read end]: read the stream and compare it
  with the first ``n`` bytes of that file: {n, same, overflow: false};
- ``stop``: end.
"""

import json
import mmap
import os
import socket
import sys

import numpy as np

READ = 1 << 20  # bytes a read


def keep(r: int, view: mmap.mmap) -> dict:
    room = len(view)
    buf = memoryview(view)
    n, overflow = 0, False
    spill = bytearray(READ)
    with open(r, "rb", buffering=0) as f:
        while True:
            got = f.readinto(buf[n : n + READ] if n < room else spill)
            if not got:
                break
            if n < room:
                n += got
            else:
                overflow = True
    buf.release()
    return {"n": n, "same": None, "overflow": overflow}


def compare(r: int, view: mmap.mmap, n_kept: int) -> dict:
    kept = np.frombuffer(view, np.uint8)[:n_kept]
    scratch = bytearray(READ)
    arr = np.frombuffer(scratch, np.uint8)
    n, same = 0, True
    with open(r, "rb", buffering=0) as f:
        while True:
            got = f.readinto(scratch)
            if not got:
                break
            if same:
                ref = kept[n : n + got]
                same = ref.shape[0] == got and bool(np.array_equal(arr[:got], ref))
            n += got
    del kept
    return {"n": n, "same": same and n == n_kept, "overflow": False}


def main() -> int:
    sock = socket.socket(fileno=int(sys.argv[1]))
    files = {}
    while True:
        data, fds, _, _ = socket.recv_fds(sock, 4096, 4)
        if not data:
            return 0
        msg = json.loads(data)
        try:
            op = msg["op"]
            if op == "stop":
                return 0
            if op == "map":
                flags = mmap.MAP_SHARED | (mmap.MAP_POPULATE if msg["populate"] else 0)
                files[msg["key"]] = mmap.mmap(fds[0], max(msg["room"], 1), flags=flags)
                os.close(fds[0])
                reply = {}
            elif op == "unmap":
                files.pop(msg["key"]).close()
                reply = {}
            elif op == "keep":
                reply = keep(fds[0], files[msg["key"]])
            elif op == "compare":
                reply = compare(fds[0], files[msg["key"]], msg["n"])
            else:
                raise ValueError(f"unknown op {op!r}")
        except Exception as e:  # answered, so that the harness raises it
            for fd in fds:
                try:
                    os.close(fd)
                except OSError:
                    pass
            reply = {"error": f"{type(e).__name__}: {e}"}
        sock.sendall(json.dumps(reply).encode() + b"\n")


if __name__ == "__main__":
    sys.exit(main())
