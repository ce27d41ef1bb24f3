"""PyTorch/CUDA port of predictionio_tpu, for NVIDIA Hopper (H100).

The JAX package ``predictionio_tpu`` is the reference; this package grows
beside it slice by slice, mirroring its module paths so each counterpart
is easy to find.  It imports ``torch`` and numpy, never ``jax`` and never
``predictionio_tpu``: what it needs from the reference it carries as its
own copy.

Entry points run on the CUDA card unless the caller asks for the CPU
(:func:`predictionio_tpu_torch.device.device`); on a CUDA tensor every
kernel wrapper launches its hand-written kernel or raises.
"""

__version__ = "0.1.0"
