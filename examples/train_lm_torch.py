"""Train an LM of the registry with repro_torch: the counterpart of
``examples/train_lm.py`` through ``repro_torch.launch.train.main``
(pipeline, AdamW with the cosine schedule, clipping, checkpoints, the
fault-tolerant loop and the straggler monitor).

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --smoke
    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen2.5-3b \\
        --smoke --steps 50            # on the CUDA card (the default)

Any flag of ``launch.train.main`` passes through (``--arch`` defaults to
qwen2.5-3b, ``--steps`` here to 30).
"""

import sys

from repro_torch.launch.train import main


def _argv(args):
    """The example's defaults in front of the caller's flags (argparse
    keeps the last value of a repeated flag)."""
    return ["--arch", "qwen2.5-3b", "--steps", "30"] + list(args)


if __name__ == "__main__":
    main(_argv(sys.argv[1:]))
