"""Device-rate tools: the port of ``tools/exp_chain.py``, ``exp_sweep.py``
and ``exp_parts.py``, run as ``python -m blt_tpu_torch.tools.<name>``."""
