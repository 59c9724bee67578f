"""The reference's examples on the port (counterparts of ``examples/``),
each run as ``python -m repro_torch.examples.<name> [--device cpu]``:
``quickstart``, ``serve_retrieval``, ``recsys_retrieval`` and
``train_lm``."""
