"""The paper's experiments on the port (counterparts of the reference's
``benchmarks/table1_preprocessing.py``, ``fig1_querytime.py``,
``table2_quality.py`` and ``examples/repro_paper.py``); each runs as
``python -m repro_torch.benchmarks.<name> --scale ... [--device cpu]`` and
writes its own JSON under the git-ignored ``benchmarks/_results/``."""
