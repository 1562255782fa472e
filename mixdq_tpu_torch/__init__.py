"""PyTorch/CUDA port of ``mixdq_tpu`` for NVIDIA Hopper (H100, sm_90a).

The package mirrors the JAX package's module layout and public layouts
(NHWC activations, HWIO conv weights, ``[K, N]`` dense weights, layer
names from ``quant.state.canonical_name``) so both compute the same
function on the same weights. It imports ``torch`` only.

Every Pallas kernel of the JAX package (those of the UNet paths it runs:
W8A8 and mixed-precision ``int8_sec``, the weight-only ``dequant`` /
``pallas_dequant``; and the two fused act-quantize GEMMs that only the
kernel benchmark, ``scripts/kernel_bench.py``, runs) has a CUDA C++
counterpart under ``csrc/``, built with ``nvcc`` at first use and bound
with ``ctypes`` (see ``ops/_build.py``). A CPU tensor takes each kernel's
plain PyTorch version; a CUDA tensor takes the kernel.
"""
