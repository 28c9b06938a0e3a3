"""ezaudio_tpu_torch: the PyTorch/CUDA port of ``ezaudio_tpu``.

Same public layout as the JAX package (``api/``, ``audio/``, ``models/``,
``ops/``, ``diffusion/``, ``codecs/``, ``text/``) and the same channel-last
``(B, L, C)`` tensors at every public function, so each module has an
obvious JAX counterpart.  The two Pallas kernels of the JAX package are
hand-written CUDA here (``csrc/``, bound in ``ops/kernels/``).

This package imports ``torch`` and never ``jax`` or ``ezaudio_tpu``.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
