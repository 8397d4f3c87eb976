"""Port conformance, the slot mesh in detect and cascade modes: the
reference's sharded trace (``tests/test_serve.py::SHARDED_CHILD``) through
a two-shard port session on the CPU, in both numerics, held to the port's
unsharded session bit for bit and to the JAX package's session (see
``test_torch_mesh.py`` for the trace, the weights — the cascade's stage 0
is the reference CLI's — and the tolerances).  The detector fires on this
trace, and the cascade's stage 1 is awake on some frames and asleep on
others."""
import pytest

from test_torch_mesh import audio, check_trace, weights  # noqa: F401


@pytest.mark.parametrize("mode", ["detect", "cascade"])
@pytest.mark.parametrize("numerics", ["float32", "int8"])
def test_reference_trace_sharded(weights, audio, mode, numerics):  # noqa: F811
    check_trace(weights, audio, mode, numerics, 2)
