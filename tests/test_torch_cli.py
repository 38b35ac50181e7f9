"""The torch port's CLI, runner and API against the JAX package's CLI.

Each case of tests/test_cli.py runs in process through both
``blt_tpu.cli.main`` and ``blt_tpu_torch.cli.main`` with the same stdin,
and the two must write the same bytes and exit the same way. A multi-batch
file goes through the port's runner with ``TorchEngine`` on the CPU. One
subprocess runs the port's main path and checks that ``jax`` was never
imported.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import blt_tpu
import blt_tpu_torch
from blt_tpu import cli as jax_cli
from blt_tpu_torch import cli as port_cli
from blt_tpu_torch.config import ContentType, CoreConfig
from blt_tpu_torch.pipeline.engines import TorchEngine
from blt_tpu_torch.pipeline.runner import run_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, args, stdin, monkeypatch):
    """(rc, stdout bytes, stderr text) of one in-process CLI call."""
    out = io.TextIOWrapper(io.BytesIO())
    err = io.StringIO()
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(stdin)))
    monkeypatch.setattr(sys, "stdout", out)
    monkeypatch.setattr(sys, "stderr", err)
    try:
        rc = main(args)
    except SystemExit as e:  # argparse rejects a flag
        rc = e.code
    out.flush()
    return rc, out.buffer.getvalue(), err.getvalue()


@pytest.fixture
def merges(tmp_path):
    path = tmp_path / "merges.txt"
    path.write_text("97 98\n")
    return str(path)


CASES = [
    ([], b"hello world"),
    (["--chunksize", "1KB"], b"some data"),
    (["--threads", "1"], b"thread test"),
    (["--input", "-", "--output", "-"], b"dash"),
    ([], b""),
    (["--memcap", "255"], b"ok"),
    (["--merges", "{m}"], b"ab c ab"),
    (["--passthrough"], b"passthrough test"),
    (["--passthrough", "--merges", "{m}"], b"raw ab"),
    (["--decode"], b"\x00h\x00i"),
    (["--decode", "--merges", "{m}"], b"\x01\x00\x00 \x00c"),
    (["--decode"], b"\x01\x00"),  # invalid token: exit 1
    (["--merges", "/nonexistent/m.txt"], b"x"),  # exit 1
    (["--memcap", "300"], b"x"),  # argparse: exit 2
    (["--threads", "xyz"], b"x"),  # argparse: exit 2
]


@pytest.mark.parametrize("engine", ["numpy", "auto"])
@pytest.mark.parametrize("ctype", [None, "text", "bin"])
@pytest.mark.parametrize("args,stdin", CASES)
def test_cli_cases_equal_jax_cli(args, stdin, ctype, engine, merges, monkeypatch):
    args = [a.replace("{m}", merges) for a in args]
    if ctype:
        args = args + ["--type", ctype]
        if "--decode" in args:  # a decode input carries the header it checks
            stdin = (0xFF01 if ctype == "text" else 0xFF03).to_bytes(2, "big") + stdin
    j_rc, j_out, j_err = _run(jax_cli.main, args + ["--engine", "numpy"], stdin, monkeypatch)
    p_rc, p_out, p_err = _run(port_cli.main, args + ["--engine", engine], stdin, monkeypatch)
    assert (p_rc, p_out) == (j_rc, j_out)
    if j_rc == 1:
        assert p_err.startswith("Error running tokenizer:")
        assert p_err == j_err


def test_cli_files_and_decode_roundtrip(tmp_path, merges, monkeypatch):
    src = tmp_path / "in.txt"
    src.write_bytes(b"ab c ab" * 100)
    for main, name in ((jax_cli.main, "jax"), (port_cli.main, "port")):
        rc, _, _ = _run(main, ["-i", str(src), "-o", str(tmp_path / f"{name}.bin"),
                               "--merges", merges, "--type", "text",
                               "--engine", "numpy"], b"", monkeypatch)
        assert rc == 0
    enc = (tmp_path / "port.bin").read_bytes()
    assert enc == (tmp_path / "jax.bin").read_bytes()
    rc, out, _ = _run(port_cli.main, ["--decode", "--merges", merges, "--type", "text"],
                      enc, monkeypatch)
    assert rc == 0 and out == src.read_bytes()


@pytest.mark.parametrize("engine_args", [["--engine", "torch"], []])
def test_engine_torch_without_cuda_exits_1(engine_args, tmp_path, monkeypatch):
    """``--engine torch``, and the default, which is the same: without a
    CUDA device the run fails naming CUDA, never quietly on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.bin"
    src = tmp_path / "in.bin"
    src.write_bytes(b"hello")
    rc, stdout, err = _run(port_cli.main, ["-i", str(src), "-o", str(out)] + engine_args,
                           b"", monkeypatch)
    assert rc == 1 and stdout == b""
    assert err.startswith("Error running tokenizer: ") and "CUDA" in err
    assert not out.exists()  # a failed run leaves no partial output
    if not engine_args:
        with pytest.raises(RuntimeError, match="CUDA"):
            blt_tpu_torch.ByteTokenizer().tokenize_file(str(src), str(out))


@pytest.mark.parametrize("mode", ["basic", "bpe", "passthrough", "decode"])
@pytest.mark.parametrize("ctype", [None, "text"])
def test_runner_with_torch_engine_on_cpu_equals_jax_cli(mode, ctype, tmp_path, merges, monkeypatch):
    """A multi-batch file (256 KiB device batches, set in conftest.py)
    through the port's runner and TorchEngine on the CPU."""
    rng = np.random.default_rng(12)
    data = rng.choice(np.frombuffer(b"abcab ab", np.uint8), 600_000).astype(np.uint8)
    src = tmp_path / "in.bin"
    src.write_bytes(data.tobytes())
    args = ["-i", str(src), "--chunksize", "64KB"]
    if mode == "bpe":
        args += ["--merges", merges]
    if mode == "passthrough":
        args += ["--passthrough"]
    if ctype:
        args += ["--type", ctype]
    if mode == "decode":
        enc = tmp_path / "enc.bin"
        assert _run(jax_cli.main, args + ["-o", str(enc)], b"", monkeypatch)[0] == 0
        args[1] = str(enc)
        args += ["--decode"]
    ref = tmp_path / "ref.bin"
    assert _run(jax_cli.main, args + ["-o", str(ref), "--engine", "numpy"], b"", monkeypatch)[0] == 0
    out = tmp_path / "out.bin"
    parser = port_cli.build_parser()
    ns = parser.parse_args(args + ["-o", str(out)])
    config = CoreConfig.new_from_cli(
        input=ns.input, output=ns.output, merges=ns.merges,
        content_type=None if not ctype else ContentType.from_cli(ctype),
        chunksize=ns.chunksize, passthrough=ns.passthrough, decode=ns.decode,
    )
    run_tokenizer(config, engine=TorchEngine(torch.device("cpu")))
    assert out.read_bytes() == ref.read_bytes()


def test_byte_tokenizer_api(tmp_path):
    with pytest.raises(ValueError, match="memory_cap"):
        blt_tpu_torch.ByteTokenizer(memory_cap=101)
    with pytest.raises(ValueError, match="content_type"):
        blt_tpu_torch.ByteTokenizer(content_type="Audio")
    with pytest.raises(ValueError, match="engine"):
        blt_tpu_torch.ByteTokenizer(engine="jax")
    assert blt_tpu_torch.version() == blt_tpu.version()
    merges = {(97, 98): 256, (256, 99): 257}  # a general table: host code
    src = tmp_path / "in.txt"
    src.write_bytes(b"abc abd ab" * 50)
    port = blt_tpu_torch.ByteTokenizer(merges={(97, 98): 300}, content_type="Text",
                                       engine="numpy")
    ref = blt_tpu.ByteTokenizer(merges={(97, 98): 300}, content_type="Text", engine="numpy")
    port.tokenize_file(str(src), str(tmp_path / "p.bin"))
    ref.tokenize_file(str(src), str(tmp_path / "r.bin"))
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "r.bin").read_bytes()
    port.detokenize_file(str(tmp_path / "p.bin"), str(tmp_path / "d.txt"))
    assert (tmp_path / "d.txt").read_bytes() == src.read_bytes()
    general = blt_tpu_torch.ByteTokenizer(merges=merges)
    toks = general.tokenize_bytes(b"abcab")
    assert toks.tolist() == blt_tpu.ByteTokenizer(merges=merges).tokenize_bytes(b"abcab").tolist()
    wire = toks.astype(">u2").tobytes()
    assert general.detokenize_bytes(wire) == b"abcab"


def test_main_path_imports_no_jax(tmp_path):
    """The port's runner, engine, encoders and CLI on the CPU, in a fresh
    interpreter: ``jax`` never enters sys.modules."""
    src = tmp_path / "in.txt"
    src.write_bytes(b"ab c ab " * 5000)
    merges = tmp_path / "m.txt"
    merges.write_text("97 98\n32 99\n")
    code = f"""
import sys, torch
import blt_tpu_torch
from blt_tpu_torch.config import CoreConfig
from blt_tpu_torch import cli
from blt_tpu_torch.pipeline.engines import TorchEngine
from blt_tpu_torch.pipeline.runner import run_tokenizer
cpu = TorchEngine(torch.device("cpu"))
for m in (None, {str(merges)!r}):
    config = CoreConfig.new_from_cli(input={str(src)!r}, output={str(tmp_path / "o.bin")!r}, merges=m)
    run_tokenizer(config, engine=cpu)
assert cli.main(["-i", {str(src)!r}, "-o", {str(tmp_path / "n.bin")!r}, "--engine", "numpy"]) == 0
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("no jax")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, env=env,
                       timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout.decode().strip() == "no jax"
