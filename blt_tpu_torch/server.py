"""HTTP tokenization service of the torch port (port of ``blt_tpu/server.py``).

A small stdlib threaded HTTP server exposing the three tokenization modes
with the CLI's semantics (mode truth table lib.rs:271-282, content-type
header lib.rs:284-294). Endpoints, status codes and error bodies are the
JAX server's:

    GET  /health            -> {"status": "ok"}
    GET  /version           -> {"version": "..."}
    POST /tokenize          -> request body bytes in, u16-BE token wire out
         query params: mode=auto|passthrough (default auto: BPE when the
                       server holds a merges table, else basic);
                       type=text|audio|bin|video (optional header token)
    POST /detokenize        -> u16-BE token wire in, original bytes out
         query params: type=... (verify + strip the header token); uses
                       the server's merges table for rule expansion

Run:  python -m blt_tpu_torch.server [--port 8149] [--merges FILE]
          [--engine torch|shard|auto|numpy] [--warmup SIZE]

``--engine torch`` (the default) serves every request on the first CUDA
device through the port's kernels (K1, K2 fused with its pack, the K3 or
K4 loop); without a CUDA device the server does not start (exit 1).
``--engine numpy`` is the way to serve on the host. One engine object
serves every request; each request runs its own stream (its own encoder,
copy stream and staging), and every launch goes on the handler thread's
current CUDA stream.
"""

from __future__ import annotations

import argparse
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from blt_tpu_torch._version import __version__
from blt_tpu_torch.config import ContentType
from blt_tpu_torch.merges import MergeTable, load_bpe_merges_from_path
from blt_tpu_torch.ops.decode import (
    build_expansion_table,
    decode_wire,
    odd_trailing_error,
    verify_strip_header,
)
from blt_tpu_torch.pipeline.engines import (
    DEVICE_ENGINES,
    DEVICE_HINT_FLOOR,
    PayloadAutoEngine,
    device_capacity_hint,
    select_engine,
)
from blt_tpu_torch.utils.logging import configure, get_logger

log = get_logger("server")


def tokenize_bytes_wire(
    data: bytes,
    table: Optional[MergeTable] = None,
    passthrough: bool = False,
    content_type: Optional[ContentType] = None,
    engine=None,
) -> bytes:
    """In-memory bytes -> u16-BE wire stream with full pipeline semantics.

    Mode truth table identical to lib.rs:271-282; the content-type header
    is prepended for every mode (lib.rs:254-263). ``engine`` defaults to
    the torch engine on the first CUDA device (raises without one).
    """
    if engine is None:
        engine = select_engine("torch", len(data))
    arr = np.frombuffer(data, dtype=np.uint8)
    if isinstance(engine, PayloadAutoEngine):  # the per-request choice
        engine = engine.select(arr.size)
    chunks = iter([arr]) if arr.size else iter(())
    hint = device_capacity_hint(arr.size, engine)
    if passthrough:
        stream = engine.passthrough_stream(chunks, hint)
    elif table is not None and len(table):
        stream = engine.bpe_stream(chunks, table, hint)
    else:
        stream = engine.basic_stream(chunks, hint)
    header = content_type.token_value.to_bytes(2, "big") if content_type else b""
    return header + b"".join(bytes(part) for part in stream)


def detokenize_wire_bytes(
    data: bytes,
    table: Optional[MergeTable] = None,
    content_type: Optional[ContentType] = None,
    exp_table=None,
) -> bytes:
    """In-memory u16-BE wire stream -> original bytes (``ops/decode.py``,
    host code). ``exp_table`` lets the server reuse one prebuilt
    ``ExpansionTable`` instead of rebuilding it per request."""
    if len(data) % 2:
        raise odd_trailing_error()
    data = verify_strip_header(data, content_type)
    if exp_table is None:
        exp_table = build_expansion_table(table.merges if table is not None else None)
    return decode_wire(np.frombuffer(data, np.uint8), exp_table).tobytes()


class _Handler(BaseHTTPRequestHandler):
    server_version = f"blt-tpu-torch/{__version__}"
    # set by make_server: table, engine, exp_table (decode expansions, built once)
    table: Optional[MergeTable] = None
    engine = None
    exp_table = None

    def log_message(self, fmt, *args):  # route access logs through BLT_LOG
        log.debug("%s %s", self.address_string(), fmt % args)

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/health":
            self._json(200, {"status": "ok"})
        elif path == "/version":
            self._json(200, {"version": __version__})
        else:
            self._json(404, {"error": f"unknown path {path}"})

    def do_POST(self):
        url = urlparse(self.path)
        if url.path not in ("/tokenize", "/detokenize"):
            self._json(404, {"error": f"unknown path {url.path}"})
            return
        params = parse_qs(url.query)
        mode = params.get("mode", ["auto"])[0]
        type_name = params.get("type", [None])[0]
        if mode not in ("auto", "passthrough"):
            self._json(400, {"error": f"unknown mode '{mode}'"})
            return
        content_type = None
        if type_name is not None:
            try:
                content_type = ContentType.from_cli(type_name)
            except KeyError:
                self._json(400, {"error": f"unknown type '{type_name}'"})
                return
        if (self.headers.get("Transfer-Encoding", "").lower() == "chunked"
                and "Content-Length" not in self.headers):
            self._json(411, {"error": "chunked bodies are not supported; "
                                      "send Content-Length"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._json(400, {"error": "malformed Content-Length"})
            return
        if length < 0:
            self._json(400, {"error": "negative Content-Length"})
            return
        data = self.rfile.read(length) if length else b""
        try:
            if url.path == "/detokenize":
                wire = detokenize_wire_bytes(
                    data, table=self.table, content_type=content_type,
                    exp_table=self.exp_table,
                )
            else:
                wire = tokenize_bytes_wire(
                    data,
                    table=self.table,
                    passthrough=(mode == "passthrough"),
                    content_type=content_type,
                    engine=self.engine,
                )
        except ValueError as e:  # malformed stream / table: client error
            self._json(400, {"error": str(e)})
            return
        except Exception as e:  # tokenization failure -> 500, not a crash
            log.exception("tokenize failed: %s", e)
            self._json(500, {"error": str(e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(wire)))
        self.end_headers()
        self.wfile.write(wire)


def make_server(
    host: str = "127.0.0.1",
    port: int = 8149,
    merges_path: Optional[Path] = None,
    threads: int = 0,
    engine="torch",
    warmup_bytes: int = 0,
    device_threshold: Optional[int] = None,
    table: Optional[MergeTable] = None,
) -> ThreadingHTTPServer:
    """Build a ready-to-serve HTTP server (port 0 = ephemeral, for tests).

    ``engine`` is an engine name or an engine object (the CPU tests pass
    ``TorchEngine(torch.device("cpu"))``). ``"torch"`` (the default) serves
    on the first CUDA device and ``"shard"`` on every CUDA device, a batch's
    rows over them; both raise without one. ``"numpy"`` serves on the host.
    ``"auto"`` applies the CLI's AUTO policy per request: payloads below
    ``device_threshold`` (default ``engines.AUTO_DEVICE_THRESHOLD``) run on
    the host engine, larger ones on the device engine when a CUDA device
    exists (``PayloadAutoEngine``). ``table`` is an in-memory table (a
    general one, which a merges file cannot hold), in place of
    ``merges_path``. ``warmup_bytes`` > 0 runs ``_warmup`` before the
    server is returned.
    """
    if merges_path is not None:
        if table is not None:
            raise ValueError("pass merges_path or table, not both")
        table = MergeTable.build(load_bpe_merges_from_path(merges_path))
    if engine == "auto":
        eng = PayloadAutoEngine(threads, device_threshold=device_threshold)
    elif isinstance(engine, str):
        eng = select_engine(engine, None, threads)
    else:
        eng = engine
    try:
        exp_table = build_expansion_table(table.merges if table is not None else None)
    except ValueError:
        # non-invertible table: the server still tokenizes; /detokenize
        # reports the build error per request
        exp_table = None
    handler = type(
        "BoundHandler",
        (_Handler,),
        {"table": table, "engine": eng, "exp_table": exp_table},
    )
    if warmup_bytes > 0:
        _warmup(eng, table, warmup_bytes)
    return ThreadingHTTPServer((host, port), handler)


def _warmup(engine, table: Optional[MergeTable], max_bytes: int) -> None:
    """Serve one payload of zeros per power-of-two capacity bucket up to
    ``max_bytes`` in the server's mode, so the first real request of any
    size finds the kernel library built and loaded, each kernel's module
    loaded, a general table placed, and a pinned and a device block of
    its bucket's size in torch's caching allocators. Always warms the
    floor bucket (every small request maps to it). Host engines have
    nothing to warm. A failure raises: the server does not start.
    """
    if getattr(engine, "name", "") == "auto":
        if engine.threshold > max(max_bytes, DEVICE_HINT_FLOOR):
            log.warning(
                "warmup: --warmup %d is below the AUTO device threshold %d: no "
                "device bucket to warm (raise --warmup or lower "
                "--device-threshold)", max_bytes, engine.threshold,
            )
            return
        # warm the device side for the payloads the threshold routes there
        dev = engine.select(engine.threshold)
        if getattr(dev, "name", "") not in DEVICE_ENGINES:
            log.info("warmup: AUTO has no device engine; skipping")
            return
        size = DEVICE_HINT_FLOOR
        while size <= max(max_bytes, DEVICE_HINT_FLOOR):
            if size >= engine.threshold:
                log.info("warmup: %d-byte bucket (auto->device)", size)
                tokenize_bytes_wire(b"\x00" * size, table=table, engine=dev)
            size <<= 1
        return
    if getattr(engine, "name", "") not in DEVICE_ENGINES:
        log.info("warmup: host engine has nothing to warm; skipping")
        return
    size = DEVICE_HINT_FLOOR
    while size <= max(max_bytes, DEVICE_HINT_FLOOR):
        log.info("warmup: %d-byte bucket", size)
        tokenize_bytes_wire(b"\x00" * size, table=table, engine=engine)
        size <<= 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    configure()
    p = argparse.ArgumentParser(
        prog="blt-serve", description="HTTP tokenization service (PyTorch + CUDA)"
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8149)
    p.add_argument("--merges", metavar="FILE", default=None,
                   help="BPE merges file (server tokenizes in BPE mode)")
    p.add_argument("--threads", type=int, default=0,
                   help="Host engine worker threads (0 = auto)")
    p.add_argument("--engine", default="torch",
                   choices=["torch", "shard", "auto", "numpy"],
                   help="Compute backend (default: torch, the CUDA kernels, "
                        "which need a CUDA device; shard = the kernels on every "
                        "CUDA device; auto = per-request threshold policy; "
                        "numpy = the host engine)")
    p.add_argument("--device-threshold", metavar="SIZE", default=None,
                   help="With --engine auto: payloads >= SIZE (e.g. 1MB) "
                        "use the CUDA device, smaller ones the host "
                        "engine (default 32MB)")
    p.add_argument("--warmup", metavar="SIZE", default=None,
                   help="Before serving, run one payload per power-of-two "
                        "bucket up to SIZE (e.g. 16MB) through the device "
                        "engine")
    args = p.parse_args(argv)
    from blt_tpu_torch.utils.parsing import parse_chunk_size_str

    warmup_bytes = 0
    device_threshold = None
    try:
        if args.warmup is not None:
            warmup_bytes = parse_chunk_size_str(args.warmup)
        if args.device_threshold is not None:
            device_threshold = parse_chunk_size_str(args.device_threshold)
    except ValueError as e:
        print(f"Error starting server: {e}", file=sys.stderr)
        return 1
    try:
        server = make_server(
            args.host, args.port,
            Path(args.merges) if args.merges else None, args.threads,
            engine=args.engine,
            warmup_bytes=warmup_bytes,
            device_threshold=device_threshold,
        )
    except (OSError, ValueError, RuntimeError) as e:
        # RuntimeError: --engine torch / shard without a CUDA device
        print(f"Error starting server: {e}", file=sys.stderr)
        return 1
    log.info("Serving on %s:%d", *server.server_address[:2])
    print(f"blt-tpu-torch serving on http://{args.host}:{server.server_address[1]}",
          file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
