"""Numeric ops of the port: top-k retrieval (library paths) and the fused
top-k kernel (K3).  Kernels are built and imported lazily, at first
launch, so importing this package needs neither nvcc nor a card."""
