"""The port's end-to-end fuzzer, conformance goldens and oracle, on the CPU.

- A bounded fuzz (``blt_tpu_torch.tools.fuzz_e2e.one_trial``, as
  tests/test_pipeline.py bounds the JAX fuzzer): random tables, corpora,
  chunk sizes and headers through the numpy, torch and shard engines on the
  CPU, and the encoder legs (the kernels' plain versions), each against the
  oracle; and real multi-process trials over gloo.
- ``make_conformance`` writes the JAX tool's files, byte for byte.
- The port's copy of the oracle gives the JAX original's tokens and wire.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from blt_tpu.ops import bpe_oracle as jax_oracle
from blt_tpu_torch.ops import bpe_oracle
from blt_tpu_torch.tools import fuzz_e2e, make_conformance

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fuzz_bounded(monkeypatch):
    """Six trials; over them the flat encoder, the halo stream and the
    resident multipass leg each run."""
    built = []
    for name in ("CudaFlatEncoder", "CudaShardedFlatEncoder", "CudaTokenEncoder"):
        cls = getattr(fuzz_e2e, name)

        def init(self, *a, _cls=cls, _name=name, **k):
            built.append(_name)
            _cls.__init__(self, *a, **k)

        monkeypatch.setattr(fuzz_e2e, name, type(name, (cls,), {"__init__": init}))
    rng = np.random.default_rng(42)
    for t in range(6):
        fuzz_e2e.one_trial(rng, t, max_bytes=60_000, device="cpu")
    assert set(built) == {"CudaFlatEncoder", "CudaShardedFlatEncoder", "CudaTokenEncoder"}


def test_fuzz_multiproc_bounded():
    rng = np.random.default_rng(7)
    for t in range(2):
        fuzz_e2e.one_multiproc_trial(rng, t, max_bytes=50_000, device="cpu")


def test_fuzz_main_on_the_cpu(capsys):
    assert fuzz_e2e.main(["--device", "cpu", "--trials", "3", "--max-bytes", "20000",
                          "--seed", "5"]) == 0
    assert "fuzz: 3 trials passed on cpu" in capsys.readouterr().out


def test_fuzz_main_needs_the_card_by_default(monkeypatch):
    from blt_tpu_torch.utils import device as device_mod

    monkeypatch.setattr(device_mod, "cuda_device", lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        fuzz_e2e.main(["--trials", "1"])


def test_make_conformance_equals_jax_tool(tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "make_conformance.py"),
                        str(jax_dir), "--size", "65536"],
                       capture_output=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    assert make_conformance.main([str(port_dir), "--size", "65536"]) == 0
    names = sorted(os.listdir(jax_dir))
    assert names == sorted(os.listdir(port_dir))
    assert {"input.bin", "merges.txt", "golden_basic.bin", "golden_passthrough.bin",
            "golden_bpe.bin", "golden_basic_type_text.bin"} <= set(names)
    for name in names:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name


@pytest.mark.parametrize("seed", range(4))
def test_oracle_copy_equals_jax(seed):
    rng = np.random.default_rng(200 + seed)
    for _ in range(8):
        merges = fuzz_e2e.make_table(rng, hierarchical=rng.random() < 0.5)
        data = fuzz_e2e.make_corpus(rng, merges, 3000)
        got = bpe_oracle.bpe_encode_oracle(data, merges)
        assert got == jax_oracle.bpe_encode_oracle(data, merges)
        assert bpe_oracle.tokens_to_be_bytes(got) == jax_oracle.tokens_to_be_bytes(got)
        # a sequence of ints, as the reference's chunk type allows
        head = list(data[:50])
        assert (bpe_oracle.bpe_encode_oracle(head, merges)
                == jax_oracle.bpe_encode_oracle(head, merges))

