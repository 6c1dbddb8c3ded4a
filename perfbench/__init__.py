"""The benchmark of the PyTorch and CUDA port ``curvlinops_tpu_torch``: one
command (``perfbench/run.py``) runs any cell of ``BENCHMARK.json``, found by
name from the files under this directory."""
