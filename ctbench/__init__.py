"""ctbench: the benchmark of the PyTorch and CUDA port ``repro_torch``.

Run one cell from the checkout's root:
``python3 ctbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``. See README.md.
"""
