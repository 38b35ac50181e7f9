"""Version of the torch port: the same string as ``blt_tpu/_version.py``.

Mirrors the reference's ``blt.version()`` / ``__version__`` surface
(reference: blt_python/src/lib.rs:205-208, blt_python/python/blt/__init__.py:14).
"""

__version__ = "0.5.0"


def version() -> str:
    """Return the library version string."""
    return __version__
