"""Serve a small model with batched requests on the PyTorch port:
continuous slot-based batching over a shared decode step
(repro_torch.launch.serve.BatchedServer). ``--arch`` picks the
architecture among those the server serves (the dense, moe, hybrid and
ssm families; encdec and vlm prefill needs frames or patches, which the
server does not pass); the model is that architecture's reduced smoke
config with weights from the seed. Runs on the CUDA card; pass --cpu to
run on the CPU instead.

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch NAME] [--cpu]
"""

import argparse

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.data import ByteTokenizer
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import build_model

SERVED_FAMILIES = ("dense", "moe", "hybrid", "ssm")


def main():
    served = [a for a in list_archs()
              if get_smoke_config(a).family in SERVED_FAMILIES]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b", choices=served,
                    help="the architecture (its smoke config) to serve")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch)
    model = build_model(cfg, seed=0, device="cpu" if args.cpu else None)
    tok = ByteTokenizer(cfg.vocab_size)

    server = BatchedServer(cfg, model, slots=4, max_len=96)
    prompts = [
        "The projection matrix maps",
        "Back-projection is",
        "Cone beam computed tomography",
        "Performance portability means",
        "Vectorization on CPUs",
        "The subline buffer caches",
    ]
    pending = [Request(prompt=tok.encode(p), max_new_tokens=24)
               for p in prompts]
    done = []

    # continuous batching: admit when slots free, decode all active
    step = 0
    while pending or any(r is not None for r in server.requests):
        while pending and server.submit(pending[0]):
            done.append(pending.pop(0))
        server.step()
        step += 1
        if step > 500:
            break

    for p, r in zip(prompts, done):
        print(f"prompt={p!r:40s} generated {len(r.out)} tokens "
              f"ids[:8]={r.out[:8]}")
    print(f"served {len(done)} requests in {step} decode steps "
          f"with {server.slots} slots (continuous batching) of "
          f"{cfg.name} ({cfg.family}) on {model.device}")


if __name__ == "__main__":
    main()
