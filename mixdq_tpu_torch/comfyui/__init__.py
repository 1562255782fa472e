"""ComfyUI custom-node package of the PyTorch port (counterpart of the
repo's root ``comfyui/``).

To install: link this directory into ComfyUI's ``custom_nodes/`` under a
name of its own (``ln -s /path/to/repo/mixdq_tpu_torch/comfyui
ComfyUI/custom_nodes/mixdq_tpu_torch_nodes``) with the repo on
``PYTHONPATH``; the nodes import the port as ``mixdq_tpu_torch``.
"""

from .nodes import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"]
