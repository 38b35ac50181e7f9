"""io subpackage (copy of ``blt_tpu/io``)."""
