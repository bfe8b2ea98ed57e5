"""metisfl_tpu_torch: the PyTorch/CUDA port of the metisfl_tpu package.

A package of its own beside the JAX package: it imports torch and numpy,
never jax and nothing of ``metisfl_tpu``, and keeps its own copies of what
it needs. It mirrors the JAX package's module paths. It trains and serves a
LlamaLite model: the wire blob (``tensor``), flash attention forward and
backward as hand-written sm_90a CUDA kernels (``ops``), the model, weight
conversion, decoding, datasets, optimizers with optax's rules and the
train/eval/inference engine (``models``), the training parameters
(``comm``), and the in-process serving gateway (``serving``). Entry
points run on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
