"""blt_tpu_torch — the byte-level tokenizer on PyTorch and CUDA.

A port of ``blt_tpu`` (JAX on a TPU) to an NVIDIA H100, beside it in the
same repository. ``blt_tpu`` stays the reference: the port's output must
equal it byte for byte. The main path, file-to-file tokenization in basic
and flat-BPE mode, runs on hand-written CUDA kernels
(``blt_tpu_torch/csrc``); host code that loads no JAX (merges, config,
I/O, chunking, the native host engine, decode) is imported from
``blt_tpu``. This package never imports ``jax``.

    >>> import blt_tpu_torch as blt
    >>> blt.ByteTokenizer(engine="torch").tokenize_file("in.txt", "out.bin")
"""

from blt_tpu._version import __version__, version
from blt_tpu.merges import load_bpe_merges
from blt_tpu_torch.api import ByteTokenizer

__all__ = ["ByteTokenizer", "load_bpe_merges", "version", "__version__"]
