"""PyTorch + CUDA port of the DeltaKWS serving path.

A second package beside ``repro`` (the JAX reference).  It imports torch,
numpy and the standard library only — never ``jax`` and never ``repro``.
Its layout mirrors ``repro``: ``frontend/fex.py`` ↔ ``repro/frontend/fex.py``
and so on.  The two Pallas kernels on the float audio→decision path are
CUDA C++ kernels for Hopper (``csrc/``), built with ``nvcc`` at first use
(``kernels/build.py``) and bound with ``ctypes``.

Entry points run on the GPU unless the caller passes ``device="cpu"``;
without a GPU they raise (``kernels.platform.resolve_device``).
"""
