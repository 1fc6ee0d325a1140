"""rene-tpu: a physically-based path tracer in JAX (pbrt-v3 frontend).

A from-scratch JAX rebuild of the capabilities of hatoo/rene (Rust + Vulkan
hardware ray tracing). Scenes compile to flat SoA device buffers;
intersection/shading run as vectorized wavefront stages that XLA compiles.
"""

__version__ = "0.1.0"
