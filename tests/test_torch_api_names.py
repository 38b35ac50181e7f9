"""The port's top-level names are the JAX package's: every name in
``blt_tpu.__all__`` is in ``blt_tpu_torch.__all__`` and resolves to the
port's own object (defined in ``blt_tpu_torch``, never imported from
``blt_tpu``), of the same kind as the original."""

import inspect

import pytest

import blt_tpu
import blt_tpu_torch


def test_the_port_exports_every_name_of_the_jax_package():
    assert set(blt_tpu.__all__) <= set(blt_tpu_torch.__all__)
    assert len(set(blt_tpu_torch.__all__)) == len(blt_tpu_torch.__all__)


@pytest.mark.parametrize("name", blt_tpu.__all__)
def test_each_name_resolves_to_the_ports_own_object(name):
    port, jax_side = getattr(blt_tpu_torch, name), getattr(blt_tpu, name)
    if isinstance(jax_side, str):  # __version__
        assert port == jax_side
        return
    assert inspect.isclass(port) == inspect.isclass(jax_side)
    assert callable(port) and port.__module__.startswith("blt_tpu_torch")
    assert port.__name__ == jax_side.__name__
