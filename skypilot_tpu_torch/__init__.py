"""skypilot_tpu_torch: the PyTorch/CUDA port of skypilot_tpu's compute stack.

The JAX package ``skypilot_tpu`` stays the reference; this package keeps
its module and public names (``models.llama.Llama``,
``ops.flash_attention.flash_attention``, ``infer.engine.InferenceEngine``,
...) so each piece has an obvious counterpart.  It imports torch and
numpy only -- never jax, flax, optax or anything under ``skypilot_tpu``.

Entry points take ``device=None``, which means the CUDA card; without a
visible card they raise instead of running on the CPU.  Pass
``device='cpu'`` to run the plain PyTorch versions of the kernels.

Importing this package loads nothing heavy; import the submodules.
"""
