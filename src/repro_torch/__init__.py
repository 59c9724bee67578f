"""PyTorch/CUDA port of the cluster-pruned weighted multi-field search
(Geraci & Pellegrini), beside the JAX reference package ``repro``.

It imports ``torch``, numpy and the standard library only — never ``jax``
and never ``repro``. Entry points run on the card (``cuda``) unless the
caller passes ``device="cpu"``; on the CPU every kernel runs its plain
PyTorch version. See ``src/repro_torch/core`` for the system and
``src/repro_torch/kernels`` for the Hopper kernels.
"""
