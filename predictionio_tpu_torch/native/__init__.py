"""Native (C++) runtime components of the port and their ctypes bindings.

Port of ``predictionio_tpu/native``: the continuous-batching serving
frontend (``serving_frontend.cc``, the port's own copy) behind ``pio
deploy --native`` and ``pio eventserver --native``, and the event-log
feeder (``feeder.cc``, the port's own copy) that assembles the deep
models' shuffled training batches.  :func:`load_library` compiles a
source with g++ at first use into ``build/torch_native/``.
"""

from predictionio_tpu_torch.native.build import load_library

__all__ = ["load_library"]
