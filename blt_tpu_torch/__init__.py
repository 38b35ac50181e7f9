"""blt_tpu_torch — the byte-level tokenizer on PyTorch and CUDA.

A port of ``blt_tpu`` (JAX on a TPU) to an NVIDIA H100, beside it in the
same repository. ``blt_tpu`` stays the reference: the port's output must
equal it byte for byte. File-to-file tokenization in basic, flat-BPE and
general-table (multipass) BPE mode runs on hand-written CUDA kernels
(``blt_tpu_torch/csrc``); the entry points run on the card unless the
caller asks for the host engine (``engine="numpy"``). The port keeps its
own copies of the host modules it needs (merges, config, I/O, chunking,
the native host library, decode) and imports nothing of ``blt_tpu`` or
``jax``.

    >>> import blt_tpu_torch as blt
    >>> blt.ByteTokenizer().tokenize_file("in.txt", "out.bin")
"""

from blt_tpu_torch._version import __version__, version
from blt_tpu_torch.api import ByteTokenizer
from blt_tpu_torch.config import ContentType, CoreConfig, Engine, Mode
from blt_tpu_torch.merges import MergeTable, load_bpe_merges, load_bpe_merges_from_path
from blt_tpu_torch.pipeline.runner import run_tokenizer

__all__ = [
    "ByteTokenizer",
    "load_bpe_merges",
    "load_bpe_merges_from_path",
    "version",
    "__version__",
    "CoreConfig",
    "ContentType",
    "Engine",
    "Mode",
    "MergeTable",
    "run_tokenizer",
]
