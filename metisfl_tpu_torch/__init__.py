"""metisfl_tpu_torch: the PyTorch/CUDA port of the metisfl_tpu package.

A package of its own beside the JAX package: it imports torch and numpy,
never jax and nothing of ``metisfl_tpu``, and keeps its own copies of what
it needs. It mirrors the JAX package's module paths. This slice serves a
LlamaLite model: the wire blob (``tensor``), the flash-attention forward as
a hand-written sm_90a CUDA kernel (``ops``), the model, weight conversion,
decoding and the inference engine (``models``), and the in-process serving
gateway (``serving``). Entry points run on ``device="cuda"`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
