"""PyTorch/CUDA port of the retrieval-based object detection framework.

The JAX package ``retrieval_based_object_detection_tpu`` is the reference;
this package mirrors its module paths and public names. Plain tensor code
is PyTorch, and every Pallas kernel on a ported path is a hand-written
CUDA kernel for Hopper (``csrc/``), built with ``nvcc`` at first use.

Entry points take ``device`` and default to ``"cuda"``: the CPU is used
only when a caller asks for it, and a missing GPU raises.
"""

__version__ = "0.1.0"
