"""The PyTorch/CUDA port of the wavefront path tracer.

Same sub-package layout and module names as the JAX reference package so
the counterpart of every module is found at the same relative path. The package
imports ``torch`` and ``numpy`` only. Entry points take an explicit
``device`` argument that defaults to ``"cuda"``; asking for a card that is
not there raises (see ``device.resolve``).
"""
__version__ = "0.1.0"
# the global spectral representation ("rgb" | "sampled"), set before parsing
from .core.spectrum import set_mode as set_spectrum_mode  # noqa: F401,E402
