"""PyTorch/CUDA port of ``mixdq_tpu`` for NVIDIA Hopper (H100, sm_90a).

The package mirrors the JAX package's module layout and public layouts
(NHWC activations, HWIO conv weights, ``[K, N]`` dense weights, layer
names from ``quant.state.canonical_name``) so both compute the same
function on the same weights. It imports ``torch`` only.

Every Pallas kernel on the W8A8 ``int8_sec`` UNet path has a CUDA C++
counterpart under ``csrc/``, built with ``nvcc`` at first use and bound
with ``ctypes`` (see ``ops/_build.py``). A CPU tensor takes each kernel's
plain PyTorch version; a CUDA tensor takes the kernel.
"""
