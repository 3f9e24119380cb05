"""Where device work runs: the compile-cache directory and the mesh,
which never moves to another backend."""
import os

import jax
import pytest

from datafusion_tpu.device import compile_cache_dir
from datafusion_tpu.parallel import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("environ,expected", [
    ({}, os.path.join(ROOT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(ROOT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/somewhere/else"}, "/somewhere/else"),
])
def test_compile_cache_dir(environ, expected):
    assert compile_cache_dir(environ) == expected


def test_compile_cache_in_effect():
    assert jax.config.jax_compilation_cache_dir == \
        compile_cache_dir(os.environ)


def test_make_mesh_uses_default_backend():
    mesh = make_mesh(4)
    assert mesh.devices.shape == (4,)
    assert {d.platform for d in mesh.devices.flat} == \
        {jax.devices()[0].platform}


def test_make_mesh_raises_without_enough_devices():
    with pytest.raises(RuntimeError, match="need"):
        make_mesh(len(jax.devices()) + 1)
