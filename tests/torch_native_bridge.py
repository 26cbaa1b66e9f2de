"""The JAX package's native bridge, loaded whole for the port's tests.

rangefilteredann_tpu/native.py runs g++ straight onto
native/libwinann_native.so and loads that path as soon as it exists. Test
workers that start together can open each other's half-written file; the
failed load then pins that bridge to None for the whole process. The port's
bridge (rangefilteredann_tpu_torch/native.py) builds the same unchanged
native/winann_native.cpp under the same g++ flags into build/native/, to a
temporary name moved into place by os.replace. `load_reference_bridge` loads
that whole library into the JAX bridge through the JAX bridge's own
signatures, so a test that holds one bridge against the other never meets
the race.
"""

import ctypes
import shutil

import pytest

from rangefilteredann_tpu import native as jnative
from rangefilteredann_tpu_torch import native as pnative


def load_reference_bridge() -> None:
    """Give both bridges a whole library, or skip where g++ is missing."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built")
    with jnative._lock:
        if jnative._lib is None:
            so = pnative._build()
            assert so is not None, "g++ failed on native/winann_native.cpp"
            lib = ctypes.CDLL(str(so))
            jnative._signatures(lib)
            jnative._lib, jnative._tried = lib, True
    assert pnative.available() and jnative.available()
