"""Serve a small model with batched requests on the PyTorch port:
continuous slot-based batching over a shared decode step
(repro_torch.launch.serve.BatchedServer). Runs on the CUDA card; pass
--cpu to run on the CPU instead.

    PYTHONPATH=src python examples/serve_lm_torch.py [--cpu]
"""

import argparse

from repro_torch.configs import ModelConfig
from repro_torch.data import ByteTokenizer
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import build_model


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args()
    cfg = ModelConfig(
        name="serve-tiny", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=384, vocab_size=4096,
        qkv_bias=True, norm="rmsnorm", activation="swiglu",
        dtype="float32", attn_chunk=128, remat=False,
    )
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
          f"with {server.slots} slots (continuous batching) on "
          f"{model.device}")


if __name__ == "__main__":
    main()
