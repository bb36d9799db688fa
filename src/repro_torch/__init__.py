"""repro_torch: the PyTorch/CUDA port of GredoDB's graph-centric cross-model
data integration & analytics (GCDIA) engine. The JAX package ``repro`` is
its reference; this package imports neither it nor JAX."""
__version__ = "0.1.0"
