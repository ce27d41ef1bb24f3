"""Native (C++) runtime components of the port and their ctypes bindings.

Port of ``predictionio_tpu/native``: the continuous-batching serving
frontend (``serving_frontend.cc``, the port's own copy) behind ``pio
deploy --native`` and ``pio eventserver --native``.  :func:`load_library`
compiles a source with g++ at first use into ``build/torch_native/``.
The feeder arrives with the deep models.
"""

from predictionio_tpu_torch.native.build import load_library

__all__ = ["load_library"]
