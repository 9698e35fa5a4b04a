#!/usr/bin/env python3
"""On-card smoke test of repro_torch, the PyTorch + CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]

It builds the CUDA kernels (K1-K6, all instances of one tiled kernel)
from the source in the checkout, prints the tiled kernel's launch plan
with the card's occupancy, registers and spills for each instance
(linear: K1/K2; two-hot: K3/K4; linear from the band layout: K5/K6),
holds each kernel against its plain PyTorch version and the oracle at
the sweep shapes, the deep columns (past nz = 2048) and the main path's
shape (K1, K2, K5 and K6 against each other, and K3 against K4, bit for
bit), and K5/K6 with bands that drop lines against their plain version,
drives the FDK main path at
the paper's P5 size (512^3 voxels, 512 views, 512x512 detector) through
``repro_torch.reconstruct`` with each CUDA variant (``subline_pl``,
``onehot_pl``, ``banded_pl``, each at nb=8 and nb=1), checks that each
path launched its kernel and agrees with the ``subline_pl`` and plain
``algorithm1_mp`` paths on the card, and times the kernels, their plain
versions, the band schedule, the filter and the whole reconstructions
with CUDA events (median of 3 after a warm-up; a single timed run for a
plain version that takes over 5 s).

Then the tiled, out-of-core path: P5 through ``reconstruct(tiling=(256,
256, 96), proj_batch=128)`` (12 steps: 4 tiles x 2 mirror-paired units
and a centered slab; 4 chunks) with each CUDA variant, step- and
chunk-major, ``out="device"`` and ``"host"``, ``pipeline="sync"`` and
``"async"``, each within 1e-5 of the untiled run on the card and async
equal to sync bit for bit; P10 (1300^3 voxels, 8.8 GB) through
``tiling=(650, 650, 325)`` with a host volume and the async flush, and
through ``memory_budget=16 GiB``, each held against float64 on line
boxes as closely as the untiled run is. For each tiled run the launch
counters must show one launch of the variant's kernel per step and chunk
and no plain version; the launch plans of every call are printed, with a
profile of the tiled walk (device idle share, sync against async). The
forward projector at a reduced 128^3: phantom -> ``forward_project`` ->
tiled FDK, against the untiled FDK of the same projections.

The iterative solvers (phase ``[solve]``, run right after the sweep,
before any other profile): the forward projector's
kernel F1 against its plain version at P5 (8 views), at odd shapes with
view chunks and subsets, and on the bf16 route; F1 timed at P5 (full
scan, oversample 1) beside its bound; a 512^3 Shepp-Logan phantom
projected by F1, then SART, OS-SART (4 subsets), CGLS and FISTA-TV at P5
through ``repro_torch.runtime.solvers.solve`` with ``subline_pl`` (K2 and
F1 launched, residuals falling, no program built after iteration 1);
bf16 SART against f32; one SART iteration with ``onehot_pl`` and
``banded_pl`` against ``subline_pl``; each method on the card against
the CPU at 24^3; and a profile of one SART iteration at P5. P10's tiled
walks run last, after every profile.

Telemetry (phase ``[trace]``, right after P5, with ``REPRO_TRACE_NVTX=1``
set before ``repro_torch`` is imported): P5 ``reconstruct`` with
``subline_pl`` under ``telemetry.tracing`` and ``torch.profiler``: the
spans' counts and host time, the traced wall against the untraced one,
the device's idle time split by the span open on the main thread (and,
where none is, by the host op over it); compile spans equal to the
program cache's misses, the ``step.dispatch`` roofline args (8 x voxels x
views FLOP), a closed span tree, the ``record_function`` ranges in the
profile; the tiled walk with a host volume and the async flush, its
``flush`` spans on the flusher thread's lane. The Chrome trace goes to
``p5.trace.json`` beside this script (git ignores it).

The autotuner (phase ``[tune]``, before P10), at P5 with a fresh cache:
``algorithm1_mp`` (the plain version, the CPU's heuristic base of
``"auto"``) timed once; the wide search over the three CUDA variants with
the default budget (each must be measured; the base is the card's ladder
head, ``subline_pl``), every candidate's wall printed; ``reconstruct(variant="auto", tuning=path)``
resolving with zero measurements, held against ``algorithm1_mp`` (1e-5,
or the bf16 contract where the search picked bf16); exact-mode tuning of
the tiled host walk, bit for bit equal to the heuristic; a second
process hitting the cache; a SART tune. Each kernel's launches in the
phase (its lane launches included) join its row of the ``kernels`` line
as ``launches_tune``.

Request batching, streaming and serving (phases ``[batch]``,
``[stream]``, ``[service]``, after ``[tune]``): the rb-lane launches of
K1-K6 (one launch, the grid's z the lane) at the sweep shapes with rb =
3, odd nz and bands that drop lines, each lane equal to the solo launch
bit for bit and to the plain version within the sweep's bars; each lane
equal to its solo launch at P5 (rb = 2) and the
rb = 4 lane launch timed (``lane_ms``, per lane);
``PlanExecutor.execute_batch`` at P5 with rb = 4 for ``subline_pl``,
``onehot_pl`` and ``banded_pl`` at nb = 8 and 1, every lane equal to
``reconstruct`` of that request bit for bit with one lane launch per step
and chunk, timed against 4 sequential calls; the tiled walks, host
async and device sync, with rb = 2; a paced P5 stream (a producer thread
pushes 512 views in 1 s), ``close()`` equal to the chunk-major
``reconstruct``, its tail and hidden fraction; two sessions folded as
one lane launch per step; a ``ReconService(max_inflight=2,
max_batch=4)`` burst of 8 requests over two
warmed P5 buckets, each equal to its solo ``reconstruct``, no program
built after warm-up, batches, occupancy and p50/p99 per bucket printed,
and ``reconstruct(service=svc)`` routed. Their lane launches join each
kernel's row as ``launches_batch``.

The reconstruction fleet (phase ``[fleet]``, after ``[service]``): at P5
on the tiled host walk (``tiling=(256, 256, 96)``, 12 steps x 4 chunks),
for ``subline_pl``, ``onehot_pl`` and ``banded_pl`` at nb = 8, fleets of
``("cuda:0",)`` and ``("cuda:0",) * 2``, failover (entry 1 faults and is
retired with 0 steps) and a straggler (entry 0 sleeps, its steps are
stolen), each equal to the single-device step-major host walk bit for
bit with one launch per step and chunk; a poison step aborts; a
``ReconService(devices=("cuda:0",) * 2)`` serves two requests, each equal
to its solo walk; a fleet of two at nb = 1 (K1, K3, K5). The fleets' host
walls print beside the step host walls of ``[tiled]``; the checked runs'
launches join each kernel's row as ``launches_fleet``. One card shows the
fleet's correctness and its threads' cost, not scaling across cards.

The mesh and the dense LM (phases ``[dist]`` and ``[lm]``, after
``[fleet]``, before P10): ``CTProjectionSource`` projects a 128^3 Shepp-Logan phantom
through F1 (one launch, held to its plain version; the launch joins F1's
row as ``launches_source``) and its batches go through the (2, 2, 2)
pod/data/model mesh on ("cuda:0",) * 8; then at P5 on random views
``distributed_backproject`` on that mesh and on a (1, 1, 1) mesh, and
the tiled composition ``TiledReconstructor.backproject_distributed``,
sync and async, each within 1e-5 (rel-max) of the card's single-device
``bp_subline_symmetry_scan``, async equal to sync bit for bit, no kernel
of K1-K6 launched (one card shows correctness, not scaling).
qwen2.5-3b at full width (36 layers, d_model 2048, 151936 words) with
weights from a seeded generator on the card: in float32, prefill and
decode steps against the teacher-forced logits (rel max-abs 1e-3); in
bf16, ``BatchedServer`` (4 slots, max_len 256) serving 6 byte-tokenized
prompts 24 tokens each: prefill and decode walls, tokens/s, peak memory,
the decode step's bound (weight and cache bytes over HBM bandwidth), the
ops a step dispatches and its device busy time under the profiler.

The other LM families (phases ``[moe]`` and ``[families]``, after
``[lm]``, before P10): deepseek-v2-lite-16b at full width (MLA with
kv_lora 512, 64 experts top-6, 2 shared, 102400 words), in float32 at 3
layers (the lead dense layer and 2 MoE layers, capacity factor 16 so
nothing drops) against teacher forcing (rel 1e-3) and one MoE layer
against the per-token sum of its top-6 experts (rel 1e-4); in bf16 at
full depth (27 layers, 15.7e9 parameters) through ``BatchedServer`` with
``[lm]``'s traffic: the decode step against the all-expert bound (the
reference's dense dispatch reads every expert) and the active-only
bound, prefill, tokens/s, peak memory, ops, idle share, and the share
of routed assignments the capacity dropped. Then granite-moe-1b-a400m,
recurrentgemma-9b (a unit and a trailing layer), rwkv6-3b,
seamless-m4t-medium (frames from the seed) and internvl2-1b (256 patch
tokens) at full width and cut depth in float32 against teacher forcing
(rel 1e-3), the recurrent two also served for 8 steps.

The LM trained (phase ``[train]``, after ``[families]``, before P10; no
kernel of its own): (a) the flash backward (``attention._Flash``) in
float32 at qwen2.5-3b's head shapes (16 heads, 2 KV heads, D 128, S 256;
chunk 64 and 1024, causal and a window of 100) within 5e-5 of autograd
through ``attention_ref``; (b) qwen2.5-3b at full width, 2 layers,
float32: loss and grads rematerialized against not (rel 1e-6 per
parameter), a microbatch=2 step's loss against the full batch's (rel
1e-4), the loss at init in (0.5 ln V, 2 ln V); (c)
``launch.train.train`` at the reference's smoke configs: qwen2.5-3b's
loss falls over 30 steps, stablelm-3b's 20 straight steps equal 10 +
resume + 10 (atol 2e-5), checkpoints in a temporary directory; (d)
qwen2.5-3b at full width and depth in bf16 (3,085,938,688 parameters,
remat "nothing"): 8 ``make_train_step`` steps of 4x256 ``TokenPipeline``
tokens with finite losses and norms, step ms, tokens/s, peak memory,
ops a step, device busy and idle share, device time by kernel name, and
the step's bound (8 N T FLOPs over 989 TFLOP/s plus 26 B a parameter of
AdamW over 3.35 TB/s). No kernel of K1-K6 or F1 launches in the phase.

The LM's parallel layer and dry run (phase ``[shard]``, after
``[train]``; no kernel of its own). Meshes are in-process, every entry
the one card: (a) ``reshard_tree`` takes qwen2.5-3b's parameters (full
width, 2 layers, float32) from a (4, 2) data x model mesh to (2, 4) and
back, bit for bit, every entry holding its spec's block; (b) the sharded
train step (``shard_train_step``) on (data 2, model 2), float32, 2
layers, 4x256 tokens: two steps from one state, each loss and gnorm
within 1e-4 (rel) of the unsharded ``make_train_step``'s; (c) qwen2.5-3b
bf16 at full width and depth on the same mesh: 3 sharded steps beside 3
unsharded ones from the same seed, step ms, tokens/s, peak memory,
per-entry state bytes against total / entries, and one step's counted
FLOPs (``launch.hlo_cost``) against 8 N T; (d) ``shard_decode_step``:
float32 at 2 layers within 1e-5 (rel) of the unsharded logits, then bf16
at full width through ``BatchedServer`` with ``[lm]``'s traffic (ms a
step, tokens' agreement with the unsharded server); (e)
``compressed_psum`` over the data axis of (4, 2) against the plain sum,
within n_members x scale / 2 an element; (f) the dry run's qwen2.5-3b x
decode_32k cell on the abstract (16, 16) mesh, its record and roofline
row. No kernel of K1-K6 or F1 launches in the phase.

Every phase is a hard failure. The last line of standard output is
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed. Without a CUDA device, or without the rest of the repository
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BAR = 1e-5                        # tests/test_kernels.py BAR
SWEEP = [(16, 24, 6), (16, 16, 4), (13, 17, 5), (8, 32, 3), (20, 12, 7),
         (15, 20, 6)]             # + an odd-nz case the fused kernel takes
# Deep 16x16-line columns (nz, detector, views): every k-per-lane
# instance of the kernel and several k chunks, at detectors up to 1024
# rows.
DEPTHS = [(70, 64, 4), (129, 96, 5), (200, 128, 4), (500, 256, 3),
          (1000, 512, 4), (1301, 1024, 8)]
BLOCKS = [(1, 8), (2, 8), (4, 8), (4, 16)]
# On 16 x 16 lines, through _deep_tiled: past the 2048 planes that the
# kernel K1-K6 ran on before the tiled one took, and detectors so fine that
# the windows overflow their columns (2.4 pixels a voxel) and their rows
# too (7.2: both global-read paths)
DEEP_SUBLINE = [(2049, 1024, 4), (2600, 1024, 4), (300, 900, 4),
                (100, 900, 4)]
SUBLINE_PLAIN_BAR = 1e-7          # K1/K2 against their plain version
ONEHOT_PLAIN_BAR = 4e-8           # K3/K4 against their plain version
K2_NBS = [1, 2, 4, 8]             # K2 timed at P5 at each nb
NBS = [2, 3, 8]
K_CHUNKS = [4, 8, 128]            # one-hot k tiles (4 divides no khp here)
BWS = [8, 16, 32]                 # banded starting band widths
BANDED = [(16, 48, 4, 16), (13, 17, 5, 8)]   # tests/test_kernels.py cases
SHIFT_BW = 8                      # bands of the line-dropping (shifted) case
ONEHOT_K1_BAR = 1e-6              # tests/test_kernels.py, K3 against K1
FLOPS_PER_UPDATE = 8.0            # the repo's ct-backproject cost model
PEAK_FP32_FLOPS = 67e12           # H100 SXM, non-tensor FP32
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
LONG_RUN_MS = 5000.0              # above this, one timed run
SRC = "src/repro_torch/kernels/csrc/backproject_subline.cu"
# launch counter -> (label: the wrapper and the CUDA kernel it launches,
# TPU kernel it replaces)
KERNELS = {
    "backproject_subline_kernel": (
        "K1 backproject_subline_kernel (tile_kernel, linear form)",
        "src/repro/kernels/backproject_subline.py:204"),
    "backproject_subline_fused": (
        "K2 backproject_subline_fused (tile_kernel, linear form)",
        "src/repro/kernels/backproject_subline.py:240"),
    "backproject_onehot_kernel": (
        "K3 backproject_onehot_kernel (tile_kernel, two-hot form)",
        "src/repro/kernels/backproject_onehot.py:144"),
    "backproject_onehot_fused": (
        "K4 backproject_onehot_fused (tile_kernel, two-hot form)",
        "src/repro/kernels/backproject_onehot.py:175"),
    "backproject_banded_kernel": (
        "K5 backproject_banded_kernel (tile_kernel, linear form, banded)",
        "src/repro/kernels/backproject_banded.py:148"),
    "backproject_banded_fused": (
        "K6 backproject_banded_fused (tile_kernel, linear form, banded)",
        "src/repro/kernels/backproject_banded.py:186"),
}
SOURCES = ["backproject_subline", "forward_project"]
F1 = "forward_project_kernel"
F1_SRC = "src/repro_torch/kernels/csrc/forward_project.cu"
F1_LABEL = "F1 forward_project_kernel (march_kernel)"
F1_REPLACES = "src/repro/core/forward.py:97"
# float32 operations of one valid sample of march_kernel: the step
# position (3), the fractional index per axis (4 x 3), its floor (3) and
# weight (3), seven linear blends (4 x 7), the add (1)
F1_FLOPS_PER_SAMPLE = 50.0
F1_VIEWS = slice(0, 512, 64)      # P5 views F1 is held to its plain on
# (nx, ny, nz, nw, nh, views, proj_batch, views=) of the odd-shape checks
F1_ODD = [(13, 17, 5, 17, 13, 5, 2, slice(1, None, 2)),
          (13, 17, 5, 17, 13, 5, None, [4, 0, 2]),
          (20, 12, 7, 24, 9, 6, 4, None)]
SOLVE_ITERS = 3
SOLVE_RUNS = (("sart", {}), ("os_sart", {"proj_batch": 128}), ("cgls", {}),
              ("fista_tv", {}))
RESIDUAL_SLACK = 1.001            # tests/test_solvers.py: falling residuals
BF16_CONTRACT = 2e-2              # tests/test_solvers.py: bf16 against f32
SOLVER_CPU_BAR = 1e-4             # tests/test_torch_solvers.py
SMALL_SOLVE = dict(n=24, n_det=32, n_proj=16)
# the tiled kernel's instances: (name, form, banded)
INSTANCES = (("linear", 0, 0), ("two-hot", 1, 0), ("banded", 0, 1))


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def rel_rmse(a, b) -> float:
    """tests/conftest.py::rel_rmse, on tensors, in float64."""
    a = a.double()
    b = b.double()
    scale = max(float(b.abs().max()), 1e-12)
    return float(((a - b) ** 2).mean().sqrt()) / scale


def timed(fn, reps: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, each bracketed by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def timed_long(fn) -> tuple:
    """``timed(fn)``, or where one run takes over LONG_RUN_MS (the plain
    versions at P5), that single run. Returns (ms, how)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    if ms > LONG_RUN_MS:
        return ms, "one timed run (a run exceeds 5 s)"
    return timed(fn), "median of 3 after a warm-up"


def launch_modules():
    from repro_torch.kernels import backproject_banded as kb
    from repro_torch.kernels import backproject_onehot as ko
    from repro_torch.kernels import backproject_subline as ks
    return ks, ko, kb


def counter_modules():
    """Every module with a launch counter: K1-K6 and F1."""
    from repro_torch.kernels import forward_project as kf
    return launch_modules() + (kf,)


def reset_launches() -> None:
    for mod in counter_modules():
        mod.reset_launches()


def launches() -> dict:
    out = {}
    for mod in counter_modules():
        out.update(mod.LAUNCHES)
    return out


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device() -> str:
    import torch
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60)
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    print(f"[device] python {sys.version.split()[0]}, torch "
          f"{torch.__version__} (CUDA {torch.version.cuda}), nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    return card


def phase_build() -> None:
    """All sources at once: one nvcc each, started together. The
    compiler's report names each instance (tile_kernel<kpt, form>)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(SOURCES)
    print(f"[build] {len(SOURCES)} sources in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        print(f"[build] {name}.cu: nvcc "
              f"{_build.build_log[name]['seconds']:.2f} s")
        for line in _build.build_log[name]["log"].splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling" in line:
                print(f"[build]   {line.strip()}")


def _sweep_case(geom, seed, errs, blocks, k_chunks, bws) -> tuple:
    """K1-K6 against their plain versions and the oracle on one geometry;
    returns how many banded cases the band search widened and how many
    shifted-band cases dropped lines."""
    import numpy as np
    import torch
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import backproject_ref
    ks, ko, kb = launch_modules()

    npj = geom.n_proj
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(
        rng.rand(npj, geom.nh, geom.nw).astype(np.float32)).cuda()
    img_t = transpose_projections(img)
    mats = projection_matrices(geom)
    shape = geom.volume_shape_xyz
    ni, nj, nz = shape
    nw = geom.nw
    ref = backproject_ref(img_t, mats, shape)
    mid = nz // 2 if nz % 2 else None
    fused_nbs = [nb for nb in NBS + [npj] if npj % nb == 0]
    lines = {"subline": [], "onehot": [], "banded": []}

    def check(family, label, kernel, out, plain):
        torch.cuda.synchronize()
        r_plain, r_ref = rel_rmse(out, plain), rel_rmse(out, ref)
        errs[kernel] = max(errs[kernel], float((out - plain).abs().max()))
        msg = f"{label} vs plain {r_plain:.2e} vs oracle {r_ref:.2e}"
        require(r_plain < BAR and r_ref < BAR, msg)
        bar = {"subline": SUBLINE_PLAIN_BAR,
               "onehot": ONEHOT_PLAIN_BAR}.get(family)
        if bar is not None:
            require(r_plain < bar,
                    f"{msg} (bar {bar} against the plain version)")
        if mid is not None:
            r_mid = rel_rmse(out[..., mid], ref[..., mid])
            msg += f" middle plane {r_mid:.2e}"
            require(r_mid < BAR, msg)
        lines[family].append((max(r_plain, r_ref), msg))

    # K1/K2: the tiled sub-line kernel, on the ragged volume and padded to
    # each block; every call gives K1's volume bit for bit
    sub_plain = ks.backproject_subline_plain(img_t, mats, shape)
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    check("subline", "K1 unpadded", "backproject_subline_kernel", k1,
          sub_plain)

    def same_as_k1(label, out):
        require(torch.equal(out, k1), f"{label} is not bitwise equal to K1")
        return out

    for block in blocks:
        check("subline", f"K1 block={block}", "backproject_subline_kernel",
              same_as_k1(f"K1 block={block}", ops._run_padded(
                  ks.backproject_subline_kernel, img_t, mats, shape, block)),
              sub_plain)
        for nb in fused_nbs:
            check("subline", f"K2 block={block} nb={nb}",
                  "backproject_subline_fused",
                  same_as_k1(f"K2 block={block} nb={nb}", ops._run_padded(
                      ks.backproject_subline_fused, img_t, mats, shape,
                      block, nb=nb)), sub_plain)
        for nb in NBS:      # the routed wrapper: K2 when nb | np, else K1
            out = same_as_k1(f"ops block={block} nb={nb}",
                             ops.backproject_subline(img_t, mats, shape,
                                                     nb=nb, block=block,
                                                     proj_loop=True))
            check("subline", f"ops block={block} nb={nb}",
                  "backproject_subline_kernel" if npj % nb
                  else "backproject_subline_fused", out, sub_plain)

    # K3/K4: the tiled kernel's two-hot form; every call gives unpadded
    # K3's volume bit for bit (k_chunk and nb change no bit), within 1e-6
    # of K1
    plain = ko.backproject_onehot_plain(img_t, mats, shape, k_chunk=8)
    k3 = ko.backproject_onehot_kernel(img_t, mats, shape)
    check("onehot", "K3 unpadded", "backproject_onehot_kernel", k3, plain)
    r = rel_rmse(k3, k1)
    require(r < ONEHOT_K1_BAR, f"K3 is {r:.2e} from K1 (bar {ONEHOT_K1_BAR})")

    def same_as_k3(label, out):
        require(torch.equal(out, k3), f"{label} is not bitwise equal to K3")
        return out

    for block in blocks:
        for kc in k_chunks:
            check("onehot", f"K3 block={block} k_chunk={kc}",
                  "backproject_onehot_kernel",
                  same_as_k3(f"K3 block={block} k_chunk={kc}",
                             ops._run_padded(ko.backproject_onehot_kernel,
                                             img_t, mats, shape, block,
                                             k_chunk=kc)), plain)
            for nb in fused_nbs:
                label = f"K4 block={block} k_chunk={kc} nb={nb}"
                check("onehot", label, "backproject_onehot_fused",
                      same_as_k3(label, ops._run_padded(
                          ko.backproject_onehot_fused, img_t, mats, shape,
                          block, k_chunk=kc, nb=nb)), plain)
        for nb in NBS:
            out = same_as_k3(f"ops block={block} nb={nb}",
                             ops.backproject_onehot(
                                 img_t, mats, shape, nb=nb, block=block,
                                 k_chunk=k_chunks[0], proj_loop=True))
            check("onehot", f"ops block={block} nb={nb}",
                  "backproject_onehot_kernel" if npj % nb
                  else "backproject_onehot_fused", out, plain)

    # K5/K6: the banded kernel, on the block-padded volume; the device band
    # schedule equals the same function run on the CPU
    widened = dropped = 0
    for block in blocks:
        bi, bj = block
        pshape = (-(-ni // bi) * bi, -(-nj // bj) * bj, nz)
        for bw0 in bws:
            for group in [1] + fused_nbs:
                img_b, band, bw = kb.band_schedule(
                    img_t, mats, pshape, block=block, bw=bw0, group=group)
                widened += bw != bw0
                n_bands = img_b.shape[1]
                dev_band, dev_span = kb.tile_bands(
                    mats, pshape[0], pshape[1], bi, bj, bw, n_bands, nw,
                    group=group)
                cpu_band, cpu_span = kb.tile_bands(
                    mats.cpu(), pshape[0], pshape[1], bi, bj, bw, n_bands,
                    nw, group=group)
                require(torch.equal(dev_band.cpu(), cpu_band)
                        and torch.equal(band, dev_band)
                        and dev_span == cpu_span,
                        f"device tile_bands differs from the CPU's at "
                        f"block={block} bw={bw} group={group}")
                plain = kb.backproject_banded_plain(
                    img_b, mats, band, pshape, block=block, bw=bw, nw=nw,
                    group=group)[:ni, :nj]
                if group == 1:
                    out = kb.backproject_banded_kernel(
                        img_b, mats, band, pshape, block=block, bw=bw, nw=nw)
                    kernel, label = "backproject_banded_kernel", "K5"
                else:
                    out = kb.backproject_banded_fused(
                        img_b, mats, band, pshape, block=block, bw=bw, nw=nw,
                        nb=group)
                    kernel, label = "backproject_banded_fused", \
                        f"K6 nb={group}"
                check("banded", f"{label} block={block} bw={bw0}->{bw}",
                      kernel, same_as_k1(f"{label} block={block} bw={bw}",
                                         out[:ni, :nj]), plain)
        for nb in NBS:
            out = ops.backproject_banded(img_t, mats, shape, nb=nb,
                                         block=block, bw=bws[0],
                                         proj_loop=True)
            check("banded", f"ops block={block} nb={nb}",
                  "backproject_banded_kernel" if npj % nb
                  else "backproject_banded_fused", out, sub_plain)
        dropped += _shifted_bands(img_t, mats, pshape, block, nw, npj, errs,
                                  lines["banded"])
    for family, results in lines.items():
        print(f"[kernels] {family}: volume {shape}, detector "
              f"{geom.nw}x{geom.nh}, {npj} views: {len(results)} cases "
              f"pass; worst: {max(results)[1]}")
    return widened, dropped


def _shifted_bands(img_t, mats, pshape, block, nw, npj, errs, lines) -> int:
    """K5, and K6 at nb = every view, on bands of SHIFT_BW columns moved one
    place right (no band search): the lines left of their band are dropped,
    and each kernel must agree with its plain version within BAR. Returns
    how many of the two dropped lines (differ from K1)."""
    import torch
    ks, _, kb = launch_modules()
    img_b, n_bands = kb.band_layout(img_t, SHIFT_BW)
    k1 = ks.backproject_subline_kernel(img_t, mats, pshape)
    dropped = 0
    for group in (1, npj):
        band, _ = kb.tile_bands(mats, *pshape[:2], *block, SHIFT_BW,
                                n_bands, nw, group=group)
        band = torch.clamp(band + 1, max=n_bands - 1)
        kw = dict(block=block, bw=SHIFT_BW, nw=nw)
        plain = kb.backproject_banded_plain(img_b, mats, band, pshape,
                                            group=group, **kw)
        if group == 1:
            kernel, label = "backproject_banded_kernel", "K5"
            out = kb.backproject_banded_kernel(img_b, mats, band, pshape, **kw)
        else:
            kernel, label = "backproject_banded_fused", f"K6 nb={group}"
            out = kb.backproject_banded_fused(img_b, mats, band, pshape,
                                              nb=group, **kw)
        torch.cuda.synchronize()
        r = rel_rmse(out, plain)
        errs[kernel] = max(errs[kernel], float((out - plain).abs().max()))
        differs = not torch.equal(out, k1)
        dropped += differs
        msg = (f"{label} block={block} shifted bands (bw={SHIFT_BW}) vs plain "
               f"{r:.2e}, lines dropped: {differs}")
        require(r < BAR, msg)
        lines.append((r, msg))
    return dropped


def phase_kernels_sweep(seed: int) -> dict:
    import dataclasses
    from repro_torch.core.geometry import standard_geometry
    errs = {name: 0.0 for name in KERNELS}
    cases = [(standard_geometry(n=n, n_det=det, n_proj=npj), BLOCKS,
              K_CHUNKS, BWS) for n, det, npj in SWEEP]
    cases += [(standard_geometry(n=n, n_det=det, n_proj=npj), BLOCKS,
               K_CHUNKS, [bw]) for n, det, npj, bw in BANDED]
    cases += [(dataclasses.replace(standard_geometry(n=nz, n_det=det,
                                                     n_proj=npj),
                                   nx=16, ny=16), BLOCKS, [128], [32])
              for nz, det, npj in DEPTHS]
    widened = dropped = 0
    for i, case in enumerate(cases):
        w, d = _sweep_case(case[0], seed + i, errs, *case[1:])
        widened += w
        dropped += d
    print(f"[kernels] the band search widened bw in {widened} banded cases; "
          f"the shifted bands dropped lines in {dropped} cases")
    require(widened > 0, "no banded case ran the band-width doubling loop")
    require(dropped > 0, "no shifted-band case dropped a line")
    _deep_tiled(seed + len(cases), errs)
    return errs


def _deep_tiled(seed, errs) -> None:
    """The tiled kernel at DEEP_SUBLINE, in every instance: K1 and K3
    against their plain versions and the oracle, K3 within 1e-6 of K1, K2
    (K4) at every nb bitwise equal to K1 (K3), and K5 and K6 (at every nb,
    each under its own band schedule) bitwise equal to K1. The 900-row
    detectors run the global-read paths, the deep columns the check-free
    stage 2."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.geometry import (projection_matrices,
                                           standard_geometry)
    from repro_torch.kernels.ref import backproject_ref
    ks, ko, kb = launch_modules()
    for nz, det, npj in DEEP_SUBLINE:
        geom = dataclasses.replace(standard_geometry(n=nz, n_det=det,
                                                     n_proj=npj), nx=16,
                                   ny=16)
        img = torch.from_numpy(np.random.RandomState(seed).rand(
            npj, geom.nh, geom.nw).astype(np.float32)).cuda()
        img_t = transpose_projections(img)
        mats = projection_matrices(geom)
        shape = geom.volume_shape_xyz
        plain = ks.backproject_subline_plain(img_t, mats, shape)
        ref = backproject_ref(img_t, mats, shape)
        k1 = ks.backproject_subline_kernel(img_t, mats, shape)
        torch.cuda.synchronize()
        r_plain, r_ref = rel_rmse(k1, plain), rel_rmse(k1, ref)
        errs["backproject_subline_kernel"] = max(
            errs["backproject_subline_kernel"],
            float((k1 - plain).abs().max()))
        msg = (f"K1/K2 at volume {shape}, detector {det}, {npj} views: vs "
               f"plain {r_plain:.2e}, vs oracle {r_ref:.2e}")
        require(r_plain < SUBLINE_PLAIN_BAR and r_ref < BAR, msg)
        if nz % 2:          # the direct half's odd middle plane
            r_mid = rel_rmse(k1[..., nz // 2], ref[..., nz // 2])
            msg += f", middle plane {r_mid:.2e}"
            require(r_mid < BAR, msg)
        k3 = ko.backproject_onehot_kernel(img_t, mats, shape)
        oh_plain = ko.backproject_onehot_plain(img_t, mats, shape)
        torch.cuda.synchronize()
        r3, r31 = rel_rmse(k3, oh_plain), rel_rmse(k3, k1)
        errs["backproject_onehot_kernel"] = max(
            errs["backproject_onehot_kernel"],
            float((k3 - oh_plain).abs().max()))
        msg += f"; K3 vs its plain {r3:.2e}, vs K1 {r31:.2e}"
        require(r3 < ONEHOT_PLAIN_BAR and r31 < ONEHOT_K1_BAR, msg)
        for nb in [nb for nb in K2_NBS if npj % nb == 0]:
            k2 = ks.backproject_subline_fused(img_t, mats, shape, nb=nb)
            require(torch.equal(k2, k1), f"K2 nb={nb} at nz={nz} is not "
                    f"bitwise equal to K1")
            k4 = ko.backproject_onehot_fused(img_t, mats, shape, nb=nb)
            require(torch.equal(k4, k3), f"K4 nb={nb} at nz={nz} is not "
                    f"bitwise equal to K3")
            img_b, band, bw = kb.band_schedule(img_t, mats, shape,
                                               block=(4, 8), bw=32, group=nb)
            kw = dict(block=(4, 8), bw=bw, nw=det)
            if nb == 1:
                label = "K5"
                out = kb.backproject_banded_kernel(img_b, mats, band, shape,
                                                   **kw)
            else:
                label = f"K6 nb={nb}"
                out = kb.backproject_banded_fused(img_b, mats, band, shape,
                                                  nb=nb, **kw)
            require(torch.equal(out, k1), f"{label} (bw={bw}) at nz={nz} is "
                    f"not bitwise equal to K1")
        print(f"[kernels] {msg}; K2 = K1, K4 = K3 and K5 = K6 = K1 bit for "
              f"bit")


def phase_plan(shapes) -> None:
    """The tiled kernel's launch plan at each (volume, nh), with what the
    card says of it for each instance (linear: K1/K2; two-hot: K3/K4;
    banded: K5/K6): blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
    (spill) bytes per thread. K1-K6 launch the same plan."""
    import ctypes
    ks = launch_modules()[0]
    lib = ks._lib()
    for shape, nh in shapes:
        plan = ks.launch_plan(shape, nh)
        smem = lib.bp_tile_smem_bytes(nh, plan.win_rows)
        forms = []
        for name, form, banded in INSTANCES:
            blocks, regs, local = (ctypes.c_int(), ctypes.c_int(),
                                   ctypes.c_int())
            err = lib.bp_tile_occupancy(plan.kpt, form, banded, nh,
                                        plan.win_rows, ctypes.byref(blocks),
                                        ctypes.byref(regs),
                                        ctypes.byref(local))
            require(err == 0, f"bp_tile_occupancy failed: CUDA error {err}")
            require(blocks.value >= 2, f"fewer than 2 blocks per SM at "
                    f"{shape} in the {name} instance")
            forms.append(f"{name} {blocks.value} blocks/SM, "
                         f"{regs.value} registers, {local.value} B local "
                         f"per thread")
        print(f"[plan] volume {shape} nh={nh}: tile {ks.TILE}, k chunk "
              f"{plan.k_chunk} planes (kpt {plan.kpt}) + mirrors, grid "
              f"{plan.grid}, a ring of 2 windows of {plan.win_rows} "
              f"rows, shared {smem} B; on the card: {'; '.join(forms)}")


# (volume, nh) where the tiled kernel's launch plan is printed: P5, P4
# (kpt 2), and the deep columns of DEPTHS and DEEP_SUBLINE
PLAN_SHAPES = ([((512, 512, 512), 512), ((256, 256, 256), 512)]
               + [((16, 16, nz), det)
                  for nz, det, _ in DEPTHS + DEEP_SUBLINE])
MAIN_RUNS = (
    ("subline_pl nb=8", dict(variant="subline_pl"),
     "backproject_subline_fused"),
    ("subline_pl nb=1", dict(variant="subline_pl", nb=1),
     "backproject_subline_kernel"),
    ("onehot_pl nb=8", dict(variant="onehot_pl"),
     "backproject_onehot_fused"),
    ("onehot_pl nb=1", dict(variant="onehot_pl", nb=1),
     "backproject_onehot_kernel"),
    ("banded_pl nb=8", dict(variant="banded_pl"),
     "backproject_banded_fused"),
    ("banded_pl nb=1", dict(variant="banded_pl", nb=1),
     "backproject_banded_kernel"),
)
# line boxes (i0, j0) of the P5 volume where K3/K4 are held against the
# plain one-hot version (the whole volume would take the plain version
# minutes per projection): a corner, the centre, an edge. Each box's
# rel-RMSE is scaled by the box's own largest value, and the bar there is
# the one K1 is held to against its plain version, SUBLINE_PLAIN_BAR; K1's
# own rel-RMSE against its plain version on each box is printed beside.
ONEHOT_BOXES = ((0, 0), (252, 252), (504, 0))
BOX = 8


def phase_p5(seed: int, errs: dict) -> dict:
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import ReconOptions
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.filtering import fdk_filter_chunk
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels.ref import backproject_ref
    ks, ko, kb = launch_modules()

    prob = get_problem("P5")
    geom = prob.geometry()
    shape = geom.volume_shape_xyz
    rng = np.random.default_rng(seed)
    p_host = rng.random(geom.proj_shape_hw, dtype=np.float32)
    p = torch.from_numpy(p_host).cuda()
    print(f"[P5] {prob}: projections {tuple(p.shape)} from seed {seed}, "
          f"{prob.updates:.3e} voxel-view updates")

    # ---- the main path, driven through the public entry point -------------
    main_launches = {}
    vols = {}
    for label, opts, kernel in MAIN_RUNS:
        reset_launches()
        t0 = time.perf_counter()
        vols[label] = repro_torch.reconstruct(p_host, geom,
                                              options=ReconOptions(**opts))
        torch.cuda.synchronize()
        n = launches()
        main_launches[kernel] = n[kernel]
        print(f"[P5] reconstruct {label}: {time.perf_counter() - t0:.3f} s "
              f"(host clock, input from the host), launches "
              f"{ {k: v for k, v in n.items() if v} }")
        require(n[kernel] > 0,
                f"the main path ({label}) never launched {kernel}")
        require(sum(n.values()) == n[kernel],
                f"the main path ({label}) launched other kernels: {n}")
    reset_launches()
    plain_vol = repro_torch.reconstruct(
        p, geom, options=ReconOptions(variant="algorithm1_mp"))
    torch.cuda.synchronize()
    require(sum(launches().values()) == 0,
            "the algorithm1_mp path launched a kernel")
    main = vols["subline_pl nb=8"]
    for label, vol in vols.items():
        require(tuple(vol.shape) == geom.volume_shape_zyx
                and bool(torch.isfinite(vol).all()),
                f"{label}: non-finite values or wrong shape")
        r = rel_rmse(vol, plain_vol)
        r_main = rel_rmse(vol, main)
        print(f"[P5] {label}: rel_rmse {r:.3e} vs algorithm1_mp, "
              f"{r_main:.3e} vs subline_pl nb=8 on the card; bitwise equal "
              f"to it: {bool(torch.equal(vol, main))}")
        require(r < BAR and r_main < BAR,
                f"{label} disagrees with algorithm1_mp or subline_pl")
    require(torch.equal(vols["subline_pl nb=8"], vols["subline_pl nb=1"]),
            "K1 and K2 main paths are not bitwise equal")
    for nb in (8, 1):
        require(torch.equal(vols[f"banded_pl nb={nb}"],
                            vols[f"subline_pl nb={nb}"]),
                f"banded_pl and subline_pl at nb={nb} are not bitwise equal")
    del vols, main, plain_vol

    # ---- each kernel at the main path's shape against its plain version ---
    img_t = transpose_projections(fdk_filter_chunk(p, geom, geom.n_proj))
    mats = projection_matrices(geom)
    block = (4, 8)
    bands = {}
    for kernel, group in (("backproject_banded_kernel", 1),
                          ("backproject_banded_fused", 8)):
        img_b, band, bw = kb.band_schedule(img_t, mats, shape, block=block,
                                           bw=32, group=group)
        bands[kernel] = (img_b, band, bw, group)
        print(f"[P5] band schedule group={group}: bw 32 -> {bw}, img_b "
              f"{tuple(img_b.shape)} ({img_b.numel() * 4 / 1e9:.3f} GB), "
              f"band {tuple(band.shape)}")

    def banded(kernel):
        img_b, band, bw, group = bands[kernel]
        if group == 1:
            return lambda: kb.backproject_banded_kernel(
                img_b, mats, band, shape, block=block, bw=bw, nw=geom.nw)
        return lambda: kb.backproject_banded_fused(
            img_b, mats, band, shape, block=block, bw=bw, nw=geom.nw,
            nb=group)

    calls = {
        "backproject_subline_kernel":
            lambda: ks.backproject_subline_kernel(img_t, mats, shape),
        "backproject_subline_fused":
            lambda: ks.backproject_subline_fused(img_t, mats, shape, nb=8),
        "backproject_onehot_kernel":
            lambda: ko.backproject_onehot_kernel(img_t, mats, shape),
        "backproject_onehot_fused":
            lambda: ko.backproject_onehot_fused(img_t, mats, shape, nb=8),
        "backproject_banded_kernel": banded("backproject_banded_kernel"),
        "backproject_banded_fused": banded("backproject_banded_fused"),
    }
    plain = ks.backproject_subline_plain(img_t, mats, shape)
    ref = backproject_ref(img_t, mats, shape)
    r = rel_rmse(plain, ref)
    print(f"[P5] sub-line plain version vs oracle: rel_rmse {r:.3e}")
    require(r < BAR, "the plain version disagrees with the oracle at P5")
    del ref
    plains = {"backproject_subline_kernel": plain,
              "backproject_subline_fused": plain}
    for kernel, (img_b, band, bw, group) in bands.items():
        plains[kernel] = kb.backproject_banded_plain(
            img_b, mats, band, shape, block=block, bw=bw, nw=geom.nw,
            group=group)
        r = rel_rmse(plains[kernel], plain)
        print(f"[P5] banded plain version (group={group}) vs sub-line "
              f"plain: rel_rmse {r:.3e}")
        require(r < BAR, "the banded plain version disagrees at P5")
    outs = {}
    for name, call in calls.items():
        out = call()
        torch.cuda.synchronize()
        if name.startswith("backproject_onehot"):
            # the whole volume against the sub-line plain version (the same
            # function), line boxes against the one-hot plain version
            r = rel_rmse(out, plain)
            r_boxes = []
            for i0, j0 in ONEHOT_BOXES:
                box = ko.backproject_onehot_plain(
                    img_t, mats, (BOX, BOX, geom.nz), origin=(i0, j0))
                got = out[i0:i0 + BOX, j0:j0 + BOX]
                r_box = rel_rmse(got, box)
                errs[name] = max(errs[name], float((got - box).abs().max()))
                require(r_box < SUBLINE_PLAIN_BAR, f"{name} disagrees with "
                        f"the one-hot plain version on lines ({i0}, {j0}): "
                        f"{r_box:.3e} (bar {SUBLINE_PLAIN_BAR})")
                r_k1 = rel_rmse(outs["backproject_subline_kernel"][
                    i0:i0 + BOX, j0:j0 + BOX], plain[i0:i0 + BOX,
                                                     j0:j0 + BOX])
                r_boxes.append(f"({i0}, {j0}) {r_box:.3e} (K1 vs its plain "
                               f"{r_k1:.3e})")
            what = (f"vs sub-line plain {r:.3e}; vs one-hot plain on "
                    f"{BOX}x{BOX}-line boxes: {', '.join(r_boxes)}; max abs "
                    f"{errs[name]:.3e}")
        else:
            r = rel_rmse(out, plains[name])
            errs[name] = max(errs[name],
                             float((out - plains[name]).abs().max()))
            what = f"vs plain: rel_rmse {r:.3e}, max abs {errs[name]:.3e}"
        print(f"[P5] {KERNELS[name][0]} {what} (max |plain| "
              f"{float(plain.abs().max()):.3e})")
        require(r < BAR, f"{name} disagrees with its plain version at P5")
        outs[name] = out
    # K1 against K5 (the same launch reading the bands) and K2 against K6,
    # bit for bit
    for a, b in (("backproject_subline_kernel", "backproject_banded_kernel"),
                 ("backproject_subline_fused", "backproject_banded_fused"),
                 ("backproject_subline_kernel", "backproject_subline_fused")):
        require(torch.equal(outs[a], outs[b]),
                f"{a} and {b} are not bitwise equal at P5")
    print("[P5] K1 = K5, K2 = K6 and K1 = K2 bit for bit")
    r = rel_rmse(outs["backproject_subline_kernel"], plain)
    require(r < SUBLINE_PLAIN_BAR, f"K1 is {r:.3e} from its plain version "
            f"at P5 (bar {SUBLINE_PLAIN_BAR})")
    require(torch.equal(outs["backproject_onehot_kernel"],
                        outs["backproject_onehot_fused"]),
            "K3 and K4 are not bitwise equal at P5")
    print("[P5] K3 = K4 bit for bit")
    r = rel_rmse(outs["backproject_onehot_kernel"],
                 outs["backproject_subline_kernel"])
    print(f"[P5] K3 vs K1: rel_rmse {r:.3e}")
    require(r < ONEHOT_K1_BAR, f"K3 is {r:.3e} from K1 at P5 (bar "
            f"{ONEHOT_K1_BAR})")
    del outs
    del plains, out

    # ---- times --------------------------------------------------------------
    flops = FLOPS_PER_UPDATE * prob.updates
    vol_bytes = 4 * geom.nx * geom.ny * geom.nz
    in_bytes = {name: 4 * (img_t.numel() + mats.numel())
                for name in calls}
    for kernel, (img_b, band, _, _) in bands.items():
        in_bytes[kernel] = 4 * (img_b.numel() + mats.numel() + band.numel())
    bounds = {}
    for name in calls:
        n_bytes = in_bytes[name] + vol_bytes
        t_op, t_b = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES
        bounds[name] = (max(t_op, t_b) * 1e3,
                        "operations" if t_op > t_b else "bytes")
        print(f"[P5] bound {KERNELS[name][0]}: {flops:.3e} FLOP / 67 TFLOP/s "
              f"= {t_op * 1e3:.3f} ms, {n_bytes:.3e} B / 3.35 TB/s = "
              f"{t_b * 1e3:.3f} ms -> {bounds[name][0]:.3f} ms "
              f"({bounds[name][1]})")
    times = {}
    for name, call in calls.items():
        times[name] = timed(call)
        print(f"[P5] {KERNELS[name][0]}: {times[name]:.3f} ms (median of 3 "
              f"after a warm-up), {prob.updates / times[name] / 1e6:.1f} "
              f"GUPS, {bounds[name][0] / times[name]:.4f} of the bound")
    for nb in K2_NBS:        # nb changes no launch: the same plan as K1
        ms = timed(lambda: ks.backproject_subline_fused(img_t, mats, shape,
                                                        nb=nb))
        print(f"[P5] K2 at nb={nb}: {ms:.3f} ms, "
              f"{bounds['backproject_subline_fused'][0] / ms:.4f} of the "
              f"bound")
    plain_ms = {}
    ms, how = timed_long(lambda: ks.backproject_subline_plain(img_t, mats,
                                                              shape))
    plain_ms["backproject_subline_kernel"] = \
        plain_ms["backproject_subline_fused"] = ms
    print(f"[P5] sub-line plain version: {ms:.3f} ms ({how})")
    for kernel, (img_b, band, bw, group) in bands.items():
        plain_ms[kernel], how = timed_long(
            lambda: kb.backproject_banded_plain(
                img_b, mats, band, shape, block=block, bw=bw, nw=geom.nw,
                group=group))
        print(f"[P5] banded plain version (group={group}): "
              f"{plain_ms[kernel]:.3f} ms ({how})")
    print("[P5] one-hot plain version: not run at P5. It builds the "
          "two-hot matrix A for every (line, plane, row): 6.9e10 entries "
          "per projection, 3.5e13 in all, in blocks of "
          f"{ko.PLAIN_BLOCK_BYTES >> 20} MiB, which would take the card "
          "minutes per projection. It is held against the kernel on line "
          "boxes above; its time stays not measured.")
    plain_ms["backproject_onehot_kernel"] = None
    plain_ms["backproject_onehot_fused"] = None
    for group in (1, 8):
        ms = timed(lambda: kb.band_schedule(img_t, mats, shape, block=block,
                                            bw=32, group=group))
        bw = bands["backproject_banded_kernel" if group == 1
                   else "backproject_banded_fused"][2]
        ms_layout = timed(lambda: kb.band_layout(img_t, bw))
        print(f"[P5] band schedule group={group} (tile_bands search + "
              f"band_layout, bw -> {bw}): {ms:.3f} ms per call, of which "
              f"band_layout {ms_layout:.3f} ms")
    filter_ms = timed(lambda: fdk_filter_chunk(p, geom, geom.n_proj))
    print(f"[P5] filter (fdk_filter_chunk, whole set): {filter_ms:.3f} ms")
    for label, opts, _ in MAIN_RUNS:
        ms = timed(lambda: repro_torch.reconstruct(
            p, geom, options=ReconOptions(**opts)))
        print(f"[P5] reconstruct {label} from device projections: "
              f"{ms:.3f} ms (median of 3 after a warm-up), "
              f"{prob.updates / ms / 1e6:.1f} GUPS")
    for variant in ("subline_pl", "onehot_pl", "banded_pl"):
        profile_reconstruct(p, geom, variant)
    return {name: {"name": KERNELS[name][0], "route": "cuda",
                   "source": SRC, "replaces": KERNELS[name][1],
                   "launches": main_launches[name],
                   "max_abs_err": errs[name], "ms": times[name],
                   "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
                   "bound_by": bounds[name][1], "library_ms": None}
            for name in KERNELS}


def profile_reconstruct(p, geom, variant: str) -> None:
    """Where the time of one warm P5 reconstruction goes on the card:
    device time by kernel from torch.profiler, and the device's idle
    share of the host-clock wall."""
    import torch
    import repro_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        return repro_torch.reconstruct(p, geom, variant=variant)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.device_time_total / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms == 0.0:
        print(f"[profile] {variant}: the profiler recorded no device time: "
              f"device breakdown not measured")
        return
    print(f"[profile] reconstruct {variant} at P5: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / wall_ms:.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {ms:10.3f} ms  {ms / busy_ms:.4f}  {name[:90]}")


# --------------------------------------------------------------------------
# the tiled, out-of-core path
# --------------------------------------------------------------------------

# P5 through reconstruct(tiling=...): 4 (i, j)-tiles x (2 mirror-paired
# units of 96 planes + a centered 128-plane slab) = 12 steps, 4 chunks of
# 128 views; every combination of loop order, placement and flush
TILED_P5 = dict(tiling=(256, 256, 96), proj_batch=128)
TILED_P5_STEPS = 12
TILED_RUNS = [(schedule, out, pipeline) for schedule in ("step", "chunk")
              for out in ("device", "host") for pipeline in ("sync", "async")]
# P10: 4 tiles x 2 paired units of 325 planes = 8 steps; and a memory
# budget, which the planner turns into chunk-major with a host volume
TILED_P10 = (("tiling=(650, 650, 325) out=host async",
              dict(tiling=(650, 650, 325), out="host", pipeline="async")),
             ("memory_budget=16 GiB", dict(memory_budget=16 << 30)))
FUSED = {"subline_pl": "backproject_subline_fused",
         "onehot_pl": "backproject_onehot_fused",
         "banded_pl": "backproject_banded_fused"}
FORWARD_N = 128                   # the forward projector's reduced size
# line boxes (i0, j0) of P10 held against float64: a corner, the centre,
# an edge (ONEHOT_BOXES scaled to 1300 lines)
P10_BOXES = ((0, 0), (646, 646), (1292, 0))
# a tiled volume's rel-RMSE from float64 on a box, at most this many times
# the untiled volume's: as exact as the main path (float32 rounds the
# detector row y to ~1e-4 rows at 1024 rows; on ramp-filtered white noise
# either path is ~2e-5 from float64 at P10, PERF.md §6)
EXACT_RATIO = 1.25
DEVICE = "cuda"


class PlainCalls:
    """Counts calls of the plain versions a tile step could fall back to
    (the kernels' plain versions and the slab-safe ``subline_batch_mp``),
    by wrapping them where their callers look them up."""

    def __init__(self):
        from repro_torch.core import backproject as bp
        ks, ko, kb = launch_modules()
        self.calls = 0
        for mod, name in ((ks, "backproject_subline_plain"),
                          (ko, "backproject_onehot_plain"),
                          (kb, "backproject_banded_plain"),
                          (bp, "bp_subline_batch")):
            setattr(mod, name, self._counted(getattr(mod, name)))

    def _counted(self, fn):
        def wrapped(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)
        return wrapped


def rel_rmse_chunked(a, b) -> float:
    """rel_rmse of a host (numpy) or device volume ``a`` against the
    device volume ``b``, a few planes at a time on the card, in float64."""
    import numpy as np
    import torch
    scale = max(float(b.abs().max()), 1e-12)
    sq, n = 0.0, 0
    for k0 in range(0, b.shape[0], 64):
        bk = b[k0:k0 + 64].double()
        ak = a[k0:k0 + 64]
        ak = (torch.from_numpy(np.ascontiguousarray(ak)).cuda()
              if isinstance(ak, np.ndarray) else ak).double()
        sq += float(((ak - bk) ** 2).sum())
        n += bk.numel()
    return (sq / n) ** 0.5 / scale


def box_f64(img_t, mats, origin, nz: int):
    """The back-projection of a BOX x BOX-line box at ``origin`` (global
    i, j) over all ``nz`` planes in float64, without the O3 mirror: the
    exact answer the float32 paths round differently. (i, j, k) order."""
    import torch
    ks = launch_modules()[0]
    _, nw, nh = img_t.shape
    i, j = ks._line_grid(BOX, BOX, img_t.device, origin)
    i, j = i.double(), j.double()
    k = torch.arange(nz, dtype=torch.float64, device=img_t.device)
    vol = torch.zeros((BOX * BOX, nz), dtype=torch.float64,
                      device=img_t.device)
    for s in range(img_t.shape[0]):
        m = mats[s].double()
        ok, f, ixc, dx = ks._line_scalars(m, i, j, nw)
        sm = (img_t[s][ixc].double() * (1.0 - dx)[:, None]
              + img_t[s][ixc + 1].double() * dx[:, None])
        y = (((m[1, 0] * i + m[1, 1] * j + m[1, 3]) * f)[:, None]
             + (m[1, 2] * f)[:, None] * k)
        vol += ks._interp(sm, y, nh) * torch.where(ok, f * f, 0.0)[:, None]
    return vol.reshape(BOX, BOX, nz)


def box_of(vol, origin):
    """The BOX x BOX-line box at ``origin`` of a native (nz, ny, nx)
    volume (tensor or numpy), as an (i, j, k) float64 tensor on the card."""
    import numpy as np
    import torch
    i0, j0 = origin
    box = vol[:, j0:j0 + BOX, i0:i0 + BOX]
    if isinstance(box, np.ndarray):
        box = torch.from_numpy(np.ascontiguousarray(box)).cuda()
    return box.permute(2, 1, 0).double()


class ExactBoxes:
    """Line boxes of one problem in float64 (:func:`box_f64`), and the
    untiled volume's rel-RMSE from them: a tiled volume must come as close
    to the exact answer as the untiled one does, within EXACT_RATIO."""

    def __init__(self, p, geom, origins, untiled):
        from repro_torch.core.backproject import transpose_projections
        from repro_torch.core.filtering import fdk_filter_chunk
        from repro_torch.core.geometry import projection_matrices
        img_t = transpose_projections(fdk_filter_chunk(p, geom, geom.n_proj))
        mats = projection_matrices(geom)
        self.origins = origins
        self.exact = [box_f64(img_t, mats, o, geom.nz) for o in origins]
        self.untiled = [rel_rmse(box_of(untiled, o), e)
                        for o, e in zip(origins, self.exact)]

    def check(self, label, vol) -> str:
        out = []
        for o, e, r_u in zip(self.origins, self.exact, self.untiled):
            r = rel_rmse(box_of(vol, o), e)
            require(r <= EXACT_RATIO * r_u, f"{label}: {r:.3e} from float64 "
                    f"on lines {o}, the untiled volume {r_u:.3e}")
            out.append(f"{o} {r:.3e} (untiled {r_u:.3e})")
        return "vs float64 on 8x8-line boxes: " + ", ".join(out)


class PlanLog:
    """Records the launch plan of every launch of the tiled kernel (K1-K6
    take theirs from ``backproject_subline.launch_plan``), by wrapping
    that function where the launches look it up."""

    def __init__(self):
        ks = launch_modules()[0]
        self.seen = {}
        plan_fn = ks.launch_plan

        def logged(shape, *args, **kw):
            lp = plan_fn(shape, *args, **kw)
            key = (tuple(shape), lp.kpt, lp.k_chunk, lp.grid, lp.win_rows)
            self.seen[key] = self.seen.get(key, 0) + 1
            return lp
        ks.launch_plan = logged

    def report(self) -> str:
        """The plans launched since the last report, with their counts."""
        out = [f"{n} x call {shape}: k chunk {k_chunk} (kpt {kpt}), grid "
               f"{grid}, slot {rows} rows"
               for (shape, kpt, k_chunk, grid, rows), n in self.seen.items()]
        self.seen = {}
        return "; ".join(out)


def _tiled_run(label, run, plan, kernel, plain, n_chunks):
    """One tiled run: the launches of ``kernel`` must be one per step and
    chunk, no other kernel and no plain version may run."""
    import torch
    reset_launches()
    plain.calls = 0
    vol = run()
    torch.cuda.synchronize()
    n = launches()
    want = len(plan.steps) * n_chunks
    require(n[kernel] == want and sum(n.values()) == want,
            f"{label}: launches {n}, want {want} of {kernel} (steps "
            f"{len(plan.steps)} x chunks {n_chunks})")
    require(plain.calls == 0, f"{label}: a plain version ran "
            f"{plain.calls} times")
    require(all(s.variant == plan.variant for s in plan.steps),
            f"{label}: a step runs a fallback variant")
    return vol, want


def phase_tiled_p5(seed: int, plain, plans) -> dict:
    """P5 through the tiled walks, each variant against its untiled run
    on the card; async against sync bit for bit. Returns the P5 walls."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import ReconOptions
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.fdk import _build_plan

    geom = get_problem("P5").geometry()
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.random(geom.proj_shape_hw,
                                    dtype=np.float32)).cuda()
    walls = {}
    for variant, kernel in FUSED.items():
        untiled = repro_torch.reconstruct(p, geom, variant=variant)
        exact = (ExactBoxes(p, geom, ONEHOT_BOXES, untiled)
                 if variant == "subline_pl" else None)
        walls[(variant, "untiled")] = ms = timed(
            lambda: repro_torch.reconstruct(p, geom, variant=variant))
        print(f"[tiled] P5 {variant} untiled: {ms:.3f} ms (median of 3 "
              f"after a warm-up)")
        print(f"[plan] P5 untiled {variant}: {plans.report()}")
        vols = {}
        for schedule, out, pipeline in TILED_RUNS:
            opts = ReconOptions(variant=variant, schedule=schedule, out=out,
                                pipeline=pipeline, **TILED_P5)
            plan = _build_plan(geom, variant, nb=8, interpret=True,
                               tiling=TILED_P5["tiling"], memory_budget=None,
                               proj_batch=TILED_P5["proj_batch"], out=out,
                               schedule=schedule)
            require(len(plan.steps) == TILED_P5_STEPS,
                    f"P5 tiled plan has {len(plan.steps)} steps")
            label = f"P5 {variant} {schedule} out={out} {pipeline}"

            def run():
                return repro_torch.reconstruct(p, geom, options=opts)
            vol, n = _tiled_run(label, run, plan, kernel, plain,
                                len(plan.chunks))
            require(isinstance(vol, np.ndarray) == (out == "host"),
                    f"{label}: wrong output type {type(vol).__name__}")
            r = rel_rmse_chunked(vol, untiled)
            require(r < BAR, f"{label}: rel_rmse {r:.3e} vs untiled")
            if exact is not None:
                print(f"[tiled] {label}: {exact.check(label, vol)}")
            vol = vol if isinstance(vol, np.ndarray) else vol.cpu().numpy()
            key = (schedule, out)
            same = ""
            if pipeline == "async":
                require(np.array_equal(vol, vols[key]),
                        f"{label} is not bitwise equal to sync")
                same = ", bitwise equal to sync"
            vols[key] = vol
            walls[(variant, schedule, out, pipeline)] = ms = timed(run)
            print(f"[tiled] {label}: {ms:.3f} ms (median of 3 after a "
                  f"warm-up), {ms / walls[(variant, 'untiled')]:.3f} x "
                  f"untiled; {n} launches of {kernel} = "
                  f"{len(plan.steps)} steps x {len(plan.chunks)} chunks; "
                  f"rel_rmse {r:.3e} vs untiled{same}")
        print(f"[plan] P5 tiled {variant}: {plans.report()}")
        if variant == "banded_pl":
            band_schedule_share(p, geom, plan, walls)
        del vols, untiled, exact
    return walls


def band_schedule_share(p, geom, plan, walls) -> None:
    """banded_pl recomputes its band schedule on every call of the tiled
    walk, as the reference does: the time of one call's schedule (a
    paired step's first chunk) and that times the walk's calls, against
    the step-major out="device" sync wall."""
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.filtering import fdk_filter_chunk
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.tiling import translate_matrices
    kb = launch_modules()[2]
    step = plan.steps[0]
    s0, s1 = plan.chunks[0]
    img_c = transpose_projections(fdk_filter_chunk(p[s0:s1], geom,
                                                   geom.n_proj))
    mt = translate_matrices(projection_matrices(geom)[s0:s1],
                            float(step.i0), float(step.j0),
                            float(step.k_off))
    ms = timed(lambda: kb.band_schedule(img_c, mt, step.call_shape,
                                        block=(4, 8), bw=32, group=8))
    n = len(plan.steps) * len(plan.chunks)
    wall = walls[("banded_pl", "step", "device", "sync")]
    print(f"[tiled] P5 banded_pl band schedule: {ms:.3f} ms for a call "
          f"{step.call_shape} of {s1 - s0} views (median of 3 after a "
          f"warm-up); x {n} calls = {n * ms:.3f} ms, {n * ms / wall:.4f} "
          f"of the step-major out=device sync wall {wall:.3f} ms")


def phase_tiled_p10(seed: int, plain, plans) -> None:
    """P10 (8.8 GB of volume) through the tiled walks with a host volume,
    against the untiled run on the card."""
    import gc
    import torch
    import repro_torch
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.fdk import _build_plan

    prob = get_problem("P10")
    geom = prob.geometry()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    p = torch.rand(geom.proj_shape_hw, generator=gen, device=DEVICE)
    kernel = FUSED["subline_pl"]
    print(f"[tiled] {prob}: projections {tuple(p.shape)} from seed {seed} "
          f"(on the card)")
    repro_torch.reconstruct(p, geom, variant="subline_pl")   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    untiled = repro_torch.reconstruct(p, geom, variant="subline_pl")
    torch.cuda.synchronize()
    ms_untiled = (time.perf_counter() - t0) * 1e3
    print(f"[tiled] P10 subline_pl untiled: {ms_untiled:.3f} ms (one timed "
          f"run after a warm-up)")
    exact = ExactBoxes(p, geom, P10_BOXES, untiled)
    print(f"[plan] P10 untiled subline_pl: {plans.report()}")
    for label, kw in TILED_P10:
        plan = _build_plan(geom, "subline_pl", nb=8, interpret=True,
                           tiling=kw.get("tiling"),
                           memory_budget=kw.get("memory_budget"),
                           proj_batch=None, out=kw.get("out"))
        label = f"P10 subline_pl {label}"

        def run():
            return repro_torch.reconstruct(p, geom, variant="subline_pl",
                                           **kw)
        vol, n = _tiled_run(label, run, plan, kernel, plain,
                            len(plan.chunks))
        del vol
        gc.collect()
        t0 = time.perf_counter()
        vol = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        r = rel_rmse_chunked(vol, untiled)
        print(f"[tiled] {label}: tile {plan.tile_shape}, schedule "
              f"{plan.schedule}, out={plan.out}; {ms:.3f} ms (one timed "
              f"run after a warm-up), {ms / ms_untiled:.3f} x untiled; {n} "
              f"launches of {kernel} = {len(plan.steps)} steps x "
              f"{len(plan.chunks)} chunks; rel_rmse {r:.3e} vs untiled; "
              f"{exact.check(label, vol)}")
        print(f"[plan] {label}: {plans.report()}")
        del vol
        gc.collect()
    del untiled, p, exact
    gc.collect()
    torch.cuda.empty_cache()


def profile_tiled(seed: int, walls: dict) -> None:
    """Where the time of the tiled P5 subline_pl walk goes: the device's
    idle share (busy = the union of the device's intervals) sync against
    async with out="host", and the host placement's share of the wall
    (what out="host" adds over out="device" in the same walk)."""
    import numpy as np
    import torch
    import repro_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.ct_paper import get_problem

    geom = get_problem("P5").geometry()
    p = torch.from_numpy(np.random.default_rng(seed).random(
        geom.proj_shape_hw, dtype=np.float32)).cuda()
    for pipeline in ("sync", "async"):
        def run():
            return repro_torch.reconstruct(p, geom, variant="subline_pl",
                                           out="host", pipeline=pipeline,
                                           **TILED_P5)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy_us, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                busy_us += b - a
                end = b
            elif b > end:
                busy_us += b - end
                end = b
        busy_ms = busy_us / 1e3
        dev_ms = walls[("subline_pl", "step", "device", "sync")]
        host_ms = walls[("subline_pl", "step", "host", pipeline)]
        if busy_ms == 0.0:
            print(f"[profile] tiled P5 subline_pl out=host {pipeline}: the "
                  f"profiler recorded no device time: idle share not "
                  f"measured")
        else:
            print(f"[profile] tiled P5 subline_pl out=host {pipeline}: wall "
                  f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle "
                  f"share {1.0 - busy_ms / wall_ms:.4f}")
        print(f"[profile] tiled P5 subline_pl {pipeline}: host placement "
              f"share of the wall {(host_ms - dev_ms) / host_ms:.4f} "
              f"(out=host {host_ms:.3f} ms against out=device {dev_ms:.3f} "
              f"ms, step-major, medians above)")


def phase_forward() -> None:
    """Phantom -> forward_project -> tiled FDK at FORWARD_N^3 (FORWARD_N
    views, FORWARD_N^2 detector), against the untiled FDK of the same
    projections."""
    import torch
    import repro_torch
    from repro_torch.core.geometry import standard_geometry
    from repro_torch.core.phantom import shepp_logan_3d

    n = FORWARD_N
    geom = standard_geometry(n=n, n_det=n, n_proj=n)
    t0 = time.perf_counter()
    vol = torch.from_numpy(shepp_logan_3d(n)).cuda()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    projs = repro_torch.forward_project(vol, geom, proj_batch=32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tiled = repro_torch.reconstruct(projs, geom, variant="subline_pl",
                                    tiling=(64, 64, 32), out="device")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    untiled = repro_torch.reconstruct(projs, geom, variant="subline_pl")
    torch.cuda.synchronize()
    require(bool(torch.isfinite(projs).all()) and tuple(projs.shape)
            == (n, n, n), "forward_project: non-finite or wrong shape")
    r = rel_rmse(tiled, untiled)
    sl = slice(n // 4, 3 * n // 4)
    corr = float(torch.corrcoef(torch.stack([
        tiled[sl, sl, sl].flatten(), vol[sl, sl, sl].flatten()]))[0, 1])
    print(f"[forward] {n}^3 Shepp-Logan phantom, {n} views, {n}x{n} "
          f"detector: phantom {1e3 * (t1 - t0):.1f} ms, forward_project {1e3 * (t2 - t1):.1f} ms, tiled FDK "
          f"{1e3 * (t3 - t2):.1f} ms (host clock, first calls); tiled vs "
          f"untiled FDK rel_rmse {r:.3e}, interior correlation with the "
          f"phantom {corr:.3f}")
    require(r < BAR, "the tiled FDK of forward projections disagrees with "
            "the untiled one")


# --------------------------------------------------------------------------
# the iterative solvers and the forward projector's kernel F1
# --------------------------------------------------------------------------

def shepp_logan_slabs(n: int, slab: int = 16):
    """``core.phantom.shepp_logan_3d(n)``, the same values, sampled slab by
    slab of z planes (``shepp_logan_at``) on a pool of threads (numpy
    releases the GIL): the whole-volume float64 temporaries of 512^3 take
    minutes and 10 GB."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    from repro_torch.core.phantom import shepp_logan_at
    axis = np.linspace(-1.0, 1.0, n, dtype=np.float64)
    vol = np.empty((n, n, n), np.float32)

    def fill(k0):
        Z, Y, X = np.meshgrid(axis[k0:k0 + slab], axis, axis, indexing="ij")
        vol[k0:k0 + slab] = shepp_logan_at(X, Y, Z).astype(np.float32)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(fill, range(0, n, slab)))
    return vol


def f1_valid_samples(geom, oversample: float, chunk: int = 64) -> int:
    """The march steps of every ray of the scan whose sample lies in the
    volume (the floor of each fractional index in [0, n-2]): the work
    F1's rays need, counted from each ray's chord through that box in
    float64 (the box clipped in t per axis; a step counts where its t
    lies in the clipped interval)."""
    import torch
    from repro_torch.core.forward import march_params, view_frames
    org, inv, step, t_near, n_steps = march_params(geom, oversample)
    org, inv = org.double(), inv.double()
    sizes = (geom.nx, geom.ny, geom.nz)
    frames = [torch.from_numpy(f).cuda().double() for f in view_frames(geom)]
    u = torch.arange(geom.nw, dtype=torch.float64, device=DEVICE)
    v = torch.arange(geom.nh, dtype=torch.float64, device=DEVICE)
    V, U = torch.meshgrid(v, u, indexing="ij")
    inf = float("inf")
    total = 0
    for c0 in range(0, geom.n_proj, chunk):
        src, det, ust, vst = (f[c0:c0 + chunk, :, None, None] for f in frames)
        d = det + U * ust + V * vst - src           # (k, 3, nh, nw)
        d = d / d.norm(dim=1, keepdim=True)
        lo = torch.full_like(d[:, 0], -inf)
        hi = torch.full_like(d[:, 0], inf)
        for c in range(3):
            a = (src[:, c] - org[c]) * inv[c]       # index at t = 0
            b = d[:, c] * inv[c]                    # index per unit of t
            inside = (a >= 0) & (a < sizes[c] - 1)  # the b == 0 case
            t0 = (0.0 - a) / b
            t1 = (sizes[c] - 1 - a) / b
            lo = torch.maximum(lo, torch.where(
                b == 0, torch.where(inside, -inf, inf), torch.minimum(t0, t1)))
            hi = torch.minimum(hi, torch.where(
                b == 0, torch.where(inside, inf, -inf), torch.maximum(t0, t1)))
        s_lo = torch.ceil((lo - t_near) / step - 0.5).clamp(0, n_steps)
        s_hi = torch.ceil((hi - t_near) / step - 0.5).clamp(0, n_steps)
        total += int((s_hi - s_lo).clamp(min=0).sum())
    return total


def plain_march(vol, geom, oversample, idx, chunk: int = 64):
    """F1's plain version on the card for view indices ``idx``, ``chunk``
    views at a time (bounded temporaries)."""
    import numpy as np
    import torch
    from repro_torch.core.forward import march_params, view_frames
    from repro_torch.kernels.forward_project import forward_project_plain
    org, inv, step, near, n_steps = march_params(geom, oversample)
    frames = view_frames(geom)
    out = torch.empty((len(idx), geom.nh, geom.nw), device=DEVICE)
    for c0 in range(0, len(idx), chunk):
        sel = idx[c0:c0 + chunk]
        out[c0:c0 + len(sel)] = forward_project_plain(
            vol, *(torch.from_numpy(np.ascontiguousarray(f[sel])).cuda()
                   for f in frames),
            org, inv, n_steps, geom.nh, geom.nw, step, near)
    return out


def f1_against_plain(vol, geom, oversample, views, proj_batch=None):
    """F1 through forward_project on ``views`` and its plain version on the
    same card: (F1's images, the plain images, rel_rmse, max abs diff)."""
    import numpy as np
    import torch
    from repro_torch.core.forward import forward_project
    out = forward_project(vol, geom, oversample, proj_batch=proj_batch,
                          views=views)
    idx = np.arange(geom.n_proj)
    plain = plain_march(vol, geom, oversample,
                        idx if views is None else idx[views])
    torch.cuda.synchronize()
    return out, plain, rel_rmse(out, plain), float((out - plain).abs().max())


def phase_f1(seed: int, vol, geom) -> dict:
    """F1 against its plain version (P5 on F1_VIEWS, the odd shapes with
    view chunks and subsets, the bf16 route), and F1's time at P5 (full
    scan, oversample 1) beside its bound and the plain version's time.
    Returns F1's row of the kernels line, its launches still to fill."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.forward import forward_project, march_params
    from repro_torch.core.geometry import standard_geometry
    from repro_torch.runtime.executor import ProgramCache
    from repro_torch.runtime.planner import plan_reconstruction
    from repro_torch.runtime.solvers import IterativeExecutor
    _, plain, r, err = f1_against_plain(vol, geom, 1.0, F1_VIEWS)
    print(f"[solve] F1 at P5 on views {F1_VIEWS.start}:{F1_VIEWS.stop}:"
          f"{F1_VIEWS.step}, oversample 1: vs plain rel_rmse {r:.3e}, max "
          f"abs {err:.3e} (max |plain| {float(plain.abs().max()):.3e})")
    del plain
    require(r < BAR, "F1 disagrees with its plain version at P5")
    rng = np.random.RandomState(seed)
    for nx, ny, nz, nw, nh, npj, pb, views in F1_ODD:
        g = standard_geometry(n=max(nx, ny, nz), n_det=max(nw, nh),
                              n_proj=npj)
        g = dataclasses.replace(g, nx=nx, ny=ny, nz=nz, nw=nw, nh=nh)
        v = torch.from_numpy(rng.rand(nz, ny, nx).astype(np.float32)).cuda()
        for ov in (1.0, 2.0):
            _, _, r, e = f1_against_plain(v, g, ov, views, proj_batch=pb)
            err = max(err, e)
            msg = (f"F1 at volume {(nx, ny, nz)}, detector {nw}x{nh}, "
                   f"oversample {ov}, proj_batch={pb}, views={views}: vs "
                   f"plain rel_rmse {r:.3e}, max abs {e:.3e}")
            require(r < BAR, msg)
            print(f"[solve] {msg}")
    # the bf16 route: a bf16 solver's forward program against the plain
    # version fed the same bf16-rounded volume
    plan = plan_reconstruction(geom, "subline_pl", out="device",
                               precision="bf16", solver="sart")
    ex = IterativeExecutor(geom, plan, ProgramCache(), oversample=1.0)
    k = F1_VIEWS.step
    got = ex._fp(vol, 0, k)
    want = plain_march(vol.to(torch.bfloat16).float(), geom, 1.0,
                       np.arange(k))
    r, e = rel_rmse(got, want), float((got - want).abs().max())
    err = max(err, e)
    print(f"[solve] F1 bf16 route at P5, views 0:{k}: vs plain on the "
          f"bf16-rounded volume rel_rmse {r:.3e}, max abs {e:.3e}")
    require(r < BAR, "F1's bf16 route disagrees with its plain version")
    del ex, got, want

    # ---- times ---------------------------------------------------------
    n_steps = march_params(geom, 1.0)[4]
    n_valid = f1_valid_samples(geom, 1.0)
    n_all = geom.n_proj * geom.nh * geom.nw * n_steps
    flops = F1_FLOPS_PER_SAMPLE * n_valid
    n_bytes = 4 * (vol.numel() + geom.n_proj * (geom.nh * geom.nw + 12))
    t_op, t_b = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES
    bound = max(t_op, t_b) * 1e3
    bound_by = "operations" if t_op > t_b else "bytes"
    print(f"[solve] F1 bound at P5 (full scan, oversample 1, {n_steps} "
          f"steps a ray): {n_valid:.4e} valid samples of {n_all:.4e} "
          f"({n_valid / n_all:.4f}) x {F1_FLOPS_PER_SAMPLE:.0f} FLOP / 67 "
          f"TFLOP/s = {t_op * 1e3:.3f} ms, {n_bytes:.3e} B / 3.35 TB/s = "
          f"{t_b * 1e3:.3f} ms -> {bound:.3f} ms ({bound_by})")
    ms = timed(lambda: forward_project(vol, geom, 1.0))
    ms8 = timed(lambda: forward_project(vol, geom, 1.0, views=F1_VIEWS))
    print(f"[solve] F1 at P5, full scan: {ms:.3f} ms (median of 3 after a "
          f"warm-up), {n_valid / ms / 1e6:.1f} G valid samples/s, "
          f"{bound / ms:.4f} of the bound; on the 8 views: {ms8:.3f} ms")
    idx = np.arange(geom.n_proj)
    plain8, how8 = timed_long(lambda: plain_march(vol, geom, 1.0,
                                                  idx[F1_VIEWS]))
    plain_ms, how = timed_long(lambda: plain_march(vol, geom, 1.0, idx))
    print(f"[solve] F1's plain version at P5 (64 views a chunk): full scan "
          f"{plain_ms:.3f} ms ({how}), {plain_ms / ms:.1f} x F1; on the 8 "
          f"views {plain8:.3f} ms ({how8}), {plain8 / ms8:.1f} x F1")
    return {"name": F1_LABEL, "route": "cuda", "source": F1_SRC,
            "replaces": F1_REPLACES, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None}


def device_split(prof, groups: dict) -> tuple:
    """Device busy milliseconds of a profile (the union of the device's
    intervals) and the device time of the kernels whose names contain
    each group's key."""
    from torch.autograd import DeviceType
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    split = {name: sum(e.device_time_total for e in events if key in e.name)
             / 1e3 for name, key in groups.items()}
    return busy_us / 1e3, split


def profile_sart(geom, projs) -> None:
    """Where the time of one warm SART iteration at P5 goes: wall, device
    busy and idle share, and the split into F1, the K2 back-projection and
    the rest (normalizer divisions, norms, the residual's .item())."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.solvers import solve

    def run():
        return solve(projs, geom, "sart", n_iters=1, variant="subline_pl",
                     oversample=1.0)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, split = device_split(prof, {"F1": "march_kernel",
                                      "K2": "tile_kernel"})
    if split["F1"] == 0.0 or split["K2"] == 0.0:
        print(f"[profile] SART iteration at P5: wall {wall_ms:.3f} ms; the "
              f"profiler recorded F1 {split['F1']:.3f} ms and K2 "
              f"{split['K2']:.3f} ms of device time, though both ran: "
              f"device breakdown not measured")
        return
    rest = busy - split["F1"] - split["K2"]
    print(f"[profile] one SART iteration at P5 (subline_pl, warm "
          f"executor): wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {1.0 - busy / wall_ms:.4f}; F1 {split['F1']:.3f} ms "
          f"({split['F1'] / busy:.4f} of busy), K2 {split['K2']:.3f} ms "
          f"({split['K2'] / busy:.4f}), the rest {rest:.3f} ms "
          f"({rest / busy:.4f})")


def phase_solve(seed: int) -> dict:
    """The iterative solvers at P5 on a Shepp-Logan phantom projected by
    F1, and F1's checks and times (phase_f1). Returns F1's row of the
    kernels line, its launches those of the four solves."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.forward import forward_project
    from repro_torch.core.geometry import standard_geometry
    from repro_torch.core.phantom import shepp_logan_3d
    from repro_torch.runtime.executor import ProgramCache
    from repro_torch.runtime.solvers import clear_solver_executors, solve

    require(np.array_equal(shepp_logan_slabs(40), shepp_logan_3d(40)),
            "the slab-by-slab phantom differs from core.phantom's")
    geom = get_problem("P5").geometry()
    n = geom.nx
    t0 = time.perf_counter()
    phantom = shepp_logan_slabs(n)
    t1 = time.perf_counter()
    vol = torch.from_numpy(phantom).cuda()
    print(f"[solve] {n}^3 Shepp-Logan phantom (core.phantom's values, "
          f"sampled slab by slab on 8 threads): {t1 - t0:.1f} s")
    row = phase_f1(seed, vol, geom)
    projs = forward_project(vol, geom, 1.0)
    require(bool(torch.isfinite(projs).all()) and tuple(projs.shape)
            == geom.proj_shape_hw, "F1's projections: non-finite or wrong "
            "shape")
    sl = slice(n // 4, 3 * n // 4)
    inner = vol[sl, sl, sl].flatten()

    # ---- the main path: the four solvers at P5 ----------------------------
    reset_launches()
    seen = launches()
    vols = {}
    for method, kw in SOLVE_RUNS:
        t0 = time.perf_counter()
        x, rep = solve(projs, geom, method, n_iters=SOLVE_ITERS,
                       variant="subline_pl", nb=8, oversample=1.0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        now = launches()
        n_k2 = now["backproject_subline_fused"] - \
            seen["backproject_subline_fused"]
        n_f1 = now[F1] - seen[F1]
        seen = now
        corr = float(torch.corrcoef(torch.stack([
            x[sl, sl, sl].flatten(), inner]))[0, 1])
        print(f"[solve] P5 {method} {kw or ''} subline_pl nb=8, "
              f"{SOLVE_ITERS} iterations: wall {wall:.3f} s (host clock, "
              f"normalizers included; report {rep.wall_s:.3f} s), "
              f"residuals {[f'{r:.6e}' for r in rep.residuals]}, "
              f"compiles_iter1 {rep.compiles_iter1}, compiles_warm "
              f"{rep.compiles_warm}, launches K2 {n_k2} F1 {n_f1}, extras "
              f"{rep.extras}, interior correlation with the phantom "
              f"{corr:.4f}")
        require(tuple(x.shape) == geom.volume_shape_zyx
                and bool(torch.isfinite(x).all()),
                f"{method}: non-finite values or wrong shape")
        require(rep.compiles_warm == 0, f"{method} built programs after "
                f"iteration 1")
        require(n_k2 > 0 and n_f1 > 0, f"{method} did not launch K2 and F1")
        if method != "fista_tv":
            require(all(b < a * RESIDUAL_SLACK for a, b in
                        zip(rep.residuals, rep.residuals[1:])),
                    f"{method}: residuals do not fall: {rep.residuals}")
        require(rep.residuals[-1] < rep.residuals[0],
                f"{method}: the last residual is not below the first")
        vols[method] = x
    counts = launches()
    row["launches"] = counts[F1]
    others = {k: v for k, v in counts.items()
              if v and k not in (F1, "backproject_subline_fused")}
    require(not others, f"the solvers launched other kernels: {others}")
    print(f"[solve] the four solves launched K2 "
          f"{counts['backproject_subline_fused']} and F1 {counts[F1]} "
          f"times")
    del vols
    gc.collect()

    # ---- bf16 against f32 ---------------------------------------------------
    sols, walls = {}, {}
    for precision in ("f32", "bf16"):
        def run():
            return solve(projs, geom, "sart", n_iters=2,
                         variant="subline_pl", oversample=1.0,
                         precision=precision)
        run()                               # normalizers, then a warm run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sols[precision], rep = run()
        torch.cuda.synchronize()
        walls[precision] = time.perf_counter() - t0
        print(f"[solve] P5 sart {precision}, 2 iterations, warm executor: "
              f"{walls[precision]:.3f} s (host clock), residuals "
              f"{[f'{r:.6e}' for r in rep.residuals]}")
    r = rel_rmse(sols["bf16"], sols["f32"])
    print(f"[solve] bf16 vs f32 SART at P5: rel_rmse {r:.3e} (contract "
          f"{BF16_CONTRACT}), max abs "
          f"{float((sols['bf16'] - sols['f32']).abs().max()):.3e}")
    require(r < BF16_CONTRACT, "bf16 SART is outside its contract")
    require(not torch.equal(sols["bf16"], sols["f32"]),
            "bf16 SART equals f32 SART: the adapter is a no-op")
    del sols

    # ---- K3-K6 on this path: one SART iteration with each variant -----------
    one = {}
    for variant, kernel in (("subline_pl", "backproject_subline_fused"),
                            ("onehot_pl", "backproject_onehot_fused"),
                            ("banded_pl", "backproject_banded_fused")):
        reset_launches()
        one[variant], _ = solve(projs, geom, "sart", n_iters=1,
                                variant=variant, oversample=1.0)
        torch.cuda.synchronize()
        require(launches()[kernel] > 0, f"SART {variant} never launched "
                f"{kernel}")
        r = rel_rmse(one[variant], one["subline_pl"])
        print(f"[solve] P5 one SART iteration {variant}: rel_rmse {r:.3e} "
              f"vs subline_pl, launches {launches()[kernel]} of {kernel}")
        require(r < BAR, f"SART {variant} disagrees with subline_pl")
    del one

    # ---- the card against the CPU, every method -----------------------------
    small = standard_geometry(**SMALL_SOLVE)
    p_small = torch.from_numpy(np.random.RandomState(seed).rand(
        *small.proj_shape_hw).astype(np.float32))
    for method, kw in SOLVE_RUNS:
        kw = {"proj_batch": 4} if kw else {}
        card, rep = solve(p_small.cuda(), small, method, n_iters=SOLVE_ITERS,
                          variant="subline_pl", cache=ProgramCache(), **kw)
        cpu, rep_cpu = solve(p_small, small, method, n_iters=SOLVE_ITERS,
                             variant="subline_pl", cache=ProgramCache(),
                             device="cpu", **kw)
        r = rel_rmse(card.cpu(), cpu)
        dr = max(abs(a - b) / abs(b) for a, b in
                 zip(rep.residuals, rep_cpu.residuals))
        print(f"[solve] {SMALL_SOLVE} {method}: card vs CPU rel_rmse "
              f"{r:.3e}, residuals {dr:.3e} relative")
        require(r < SOLVER_CPU_BAR and dr < SOLVER_CPU_BAR,
                f"{method} on the card disagrees with the CPU")

    profile_sart(geom, projs)
    del projs, vol
    clear_solver_executors()
    gc.collect()
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# telemetry and the autotuner
# --------------------------------------------------------------------------

TRACE_OUT = ROOT / "p5.trace.json"
# main-thread spans the device's idle time is attributed to ("none": no
# span open)
IDLE_SPANS = ("filter.chunk", "step.dispatch", "plan.build")
CUDA_VARIANTS = ("subline_pl", "onehot_pl", "banded_pl")
# variant -> (launch counter of nb-fused launches, of single-view ones)
VARIANT_KERNELS = {
    "subline_pl": ("backproject_subline_fused", "backproject_subline_kernel"),
    "onehot_pl": ("backproject_onehot_fused", "backproject_onehot_kernel"),
    "banded_pl": ("backproject_banded_fused", "backproject_banded_kernel"),
}
SART_TUNE_BUDGET_S = 30.0
# run as ``python -c SECOND_PROCESS '{"src": ..., "variants": ...,
# "path": ...}'``
SECOND_PROCESS = r"""
import json, sys
args = json.loads(sys.argv[1])
sys.path.insert(0, args["src"])
from repro_torch.configs.ct_paper import get_problem
from repro_torch.runtime import autotune as at

calls = []
orig = at._measure_config
at._measure_config = lambda *a, **k: calls.append(1) or orig(*a, **k)
geom = get_problem("P5").geometry()
cfg = at.autotune(geom, "auto", variants=tuple(args["variants"]),
                  cache=args["path"])
res = at.resolve_config(geom, "auto", cache=args["path"])
print("RESULT:" + json.dumps({"measured": len(calls), "source": cfg.source,
                              "trials": cfg.trials, "key": repr(cfg.key),
                              "resolved": res.source,
                              "resolved_key": repr(res.key)}))
"""


def _span_events(name=None):
    from repro_torch.runtime import telemetry
    return [e for e in telemetry.events() if e.get("ph") == "X"
            and (name is None or e["name"] == name)]


def _span_tree_closed() -> None:
    from repro_torch.runtime import telemetry
    spans = _span_events()
    ids = {e["args"]["span_id"] for e in spans}
    require(telemetry.open_span_count() == 0, "a span is still open")
    require(all(e["args"]["parent_id"] is None or e["args"]["parent_id"]
                in ids for e in spans), "a span's parent was not recorded")


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(prof, window: str) -> tuple:
    """The device's idle time inside the profiler range ``window`` (a
    ``record_function`` around the run), split by which span was open on
    the main thread, innermost first, and the idle time with no span open
    split by the outermost host op the profiler recorded over it. The
    spans' host clock is put on the profiler's timeline through the
    ``step.dispatch`` range, which is both a span and a
    ``record_function`` range."""
    from torch.autograd import DeviceType
    spans = _span_events()
    names = {e["name"] for e in spans} | {window}
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    anchor = [e for e in cpu if e.name == "step.dispatch"]
    win = [e for e in cpu if e.name == window]
    require(bool(anchor) and bool(win), "the profile holds no "
            "record_function range of step.dispatch or of the run")
    step = min((e for e in spans if e["name"] == "step.dispatch"),
               key=lambda e: e["ts"])
    offset = min(e.time_range.start for e in anchor) - step["ts"]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name not in names
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > w0 and e.time_range.start < w1])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    main = [(e["ts"] + offset, e["ts"] + e["dur"] + offset, e["name"])
            for e in spans if e["tid"] == "MainThread"]
    tops = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
            if e.cpu_parent is not None and e.cpu_parent.name == window
            and e.name not in names]
    split, unspanned = {}, {}
    for a, b in gaps:
        cuts = sorted({a, b} | {x for s0, s1, _ in main for x in (s0, s1)
                                if a < x < b})
        for c0, c1 in zip(cuts, cuts[1:]):
            mid = 0.5 * (c0 + c1)
            open_ = [s for s in main if s[0] <= mid < s[1]]
            name = max(open_)[2] if open_ else "none"
            split[name] = split.get(name, 0.0) + (c1 - c0) / 1e3
            if name == "none":
                for t0, t1, op in tops:
                    lap = min(c1, t1) - max(c0, t0)
                    if lap > 0:
                        unspanned[op] = unspanned.get(op, 0.0) + lap / 1e3
    busy_ms = sum(b - a for a, b in busy) / 1e3
    return (w1 - w0) / 1e3, busy_ms, split, unspanned


def phase_trace(seed: int) -> None:
    """[trace]: P5 through ``reconstruct`` (subline_pl nb=8, untiled)
    under ``telemetry.tracing`` and ``torch.profiler``: span counts and
    host time by name, the traced wall against the untraced one, and the
    device's idle time split by the main thread's open span; the span
    contracts (compile spans = program-cache misses, the roofline args,
    a closed tree, the ranges in the profile); then the tiled walk with
    a host volume and the async flush, whose flush spans must sit on the
    flusher thread's lane."""
    import numpy as np
    import torch
    import repro_torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.runtime import telemetry
    from repro_torch.runtime.executor import (PlanExecutor, ProgramCache,
                                              default_program_cache)
    from repro_torch.runtime.planner import plan_reconstruction

    t_phase = time.perf_counter()
    require(telemetry._NVTX_ANNOTATE, "REPRO_TRACE_NVTX=1 was not set "
            "before repro_torch was imported")
    geom = get_problem("P5").geometry()
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.random(geom.proj_shape_hw,
                                    dtype=np.float32)).cuda()

    def run():
        return repro_torch.reconstruct(p, geom, variant="subline_pl")

    # compile spans against the misses of a fresh program cache
    cache = ProgramCache()
    ex = PlanExecutor(geom, plan_reconstruction(geom, "subline_pl",
                                                out="device"), cache)
    with telemetry.tracing():
        ex.reconstruct(p)
        cold = (len(_span_events("compile")), cache.stats()["misses"])
        ex.reconstruct(p)
        warm = (len(_span_events("compile")), cache.stats()["misses"])
    torch.cuda.synchronize()
    print(f"[trace] fresh ProgramCache: compile spans / misses {cold[0]} / "
          f"{cold[1]} after the first call, {warm[0]} / {warm[1]} after "
          f"the second")
    require(cold[0] == cold[1] > 0 and warm == cold,
            "compile spans do not equal the program cache's misses")
    del ex, cache

    # the traced wall against the untraced one, in turns
    def wall(traced: bool) -> float:
        torch.cuda.synchronize()
        if traced:
            telemetry.enable(clear_events=True)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        telemetry.disable()
        return dt

    run()
    torch.cuda.synchronize()
    walls = {False: [], True: []}
    for i in range(6):
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            walls[traced].append(wall(traced))
    plain_ms = statistics.median(walls[False])
    traced_ms = statistics.median(walls[True])
    print(f"[trace] P5 reconstruct subline_pl, host clock to a "
          f"synchronize, median of 6 in turns: untraced {plain_ms:.3f} ms, "
          f"traced {traced_ms:.3f} ms, overhead "
          f"{traced_ms / plain_ms - 1.0:+.4f} (untraced "
          f"{min(walls[False]):.3f}-{max(walls[False]):.3f}, traced "
          f"{min(walls[True]):.3f}-{max(walls[True]):.3f})")

    # one traced run inside the profiler
    misses0 = default_program_cache().stats()["misses"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with telemetry.tracing(str(TRACE_OUT)):
            with record_function("trace.reconstruct"):
                t0 = time.perf_counter()
                vol = run()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
    require(tuple(vol.shape) == geom.volume_shape_zyx
            and bool(torch.isfinite(vol).all()),
            "the traced run: non-finite values or wrong shape")
    _span_tree_closed()
    doc = json.loads(TRACE_OUT.read_text())
    require(any(e.get("ph") == "X" for e in doc["traceEvents"]),
            "the Chrome trace holds no span")
    by_name = {}
    for e in _span_events():
        n, ms = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    print(f"[trace] traced P5 run under torch.profiler: wall "
          f"{wall_ms:.3f} ms; spans (count, summed host ms): "
          + ", ".join(f"{k} {n} {ms:.3f}" for k, (n, ms)
                      in sorted(by_name.items())))
    misses = default_program_cache().stats()["misses"] - misses0
    require(by_name.get("compile", (0, 0.0))[0] == misses,
            "compile spans do not equal the program cache's misses")
    steps = _span_events("step.dispatch")
    want = FLOPS_PER_UPDATE * geom.nx * geom.ny * geom.nz * geom.n_proj
    for e in steps:
        a = e["args"]
        print(f"[trace] step.dispatch {a['variant']} {a['call_shape']}: "
              f"{a['flops']:.4e} FLOP = 8 x {a['voxels']} voxels x "
              f"{a['n_views']} views, {a['bytes']:.4e} B modeled, "
              f"{a['ai_flop_per_byte']} FLOP/B; bound at 67 TFLOP/s "
              f"{a['flops'] / PEAK_FP32_FLOPS * 1e3:.3f} ms; host "
              f"{e['dur'] / 1e3:.3f} ms (the enqueue)")
        require(a["flops"] == FLOPS_PER_UPDATE * a["voxels"] * a["n_views"],
                "step.dispatch flops != 8 x voxels x views")
    require(len(steps) == 1 and steps[0]["args"]["flops"] == want,
            f"the untiled P5 run is not one step of {want:.4e} FLOP")
    names = {e.name for e in prof.events()}
    require("step.dispatch" in names, "the record_function range of "
            "step.dispatch is not in the profile")
    window_ms, busy_ms, split, unspanned = idle_by_span(
        prof, "trace.reconstruct")
    idle = window_ms - busy_ms
    print(f"[trace] profile window {window_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle {idle:.3f} ms (share "
          f"{idle / window_ms:.4f}); idle by open main-thread span: "
          + ", ".join(f"{k} {ms:.3f} ms ({ms / max(idle, 1e-9):.4f})"
                      for k, ms in sorted(split.items(),
                                          key=lambda kv: -kv[1])))
    require(abs(sum(split.values()) - idle) < 1e-3 * max(idle, 1.0),
            "the idle split does not add up")
    rest = split.get("none", 0.0) - sum(unspanned.values())
    print("[trace] idle with no span open, by the host op over it: "
          + ", ".join(f"{op[:60]} {ms:.3f} ms" for op, ms in
                      sorted(unspanned.items(), key=lambda kv: -kv[1])[:8])
          + f"; under no op (Python) {rest:.3f} ms")
    del vol

    # the tiled walk, host volume, async flush
    with telemetry.tracing():
        vol = repro_torch.reconstruct(p, geom, variant="subline_pl",
                                      tiling=(256, 256, 96), out="host",
                                      pipeline="async")
    _span_tree_closed()
    flushes = _span_events("flush")
    steps = _span_events("step.dispatch")
    lanes = sorted({e["tid"] for e in flushes})
    print(f"[trace] tiled P5 (256, 256, 96) out=host async: "
          f"{len(steps)} step.dispatch on "
          f"{sorted({e['tid'] for e in steps})}, {len(flushes)} flush on "
          f"{lanes}, flush host ms {sum(e['dur'] for e in flushes) / 1e3:.3f}")
    require(len(steps) == TILED_P5_STEPS and len(flushes) == len(steps)
            and lanes == ["recon-flush"],
            "the tiled async walk's flush spans are not on the flusher lane")
    require(isinstance(vol, np.ndarray) and bool(np.isfinite(vol).all()),
            "the tiled traced run: not a finite host volume")
    telemetry.clear()
    del vol, p
    print(f"[trace] phase {time.perf_counter() - t_phase:.1f} s")


def phase_tune(seed: int) -> dict:
    """[tune]: the autotuner at P5 on the card, untiled, with a fresh
    cache in a temporary directory: (a) algorithm1_mp, the plain
    version, once; (b) the wide search over the three CUDA variants with
    the default budget; (c) reconstruct(variant="auto", tuning=path) resolving
    with zero measurements, held against algorithm1_mp; (d) exact mode
    on the tiled host walk, bit for bit against the heuristic; (e) a
    second process hitting the cache; (f) a SART tune. Returns each
    kernel's launches over the phase."""
    import tempfile
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import ReconOptions
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.runtime import autotune as at
    from repro_torch.runtime import telemetry
    from repro_torch.runtime.executor import PlanExecutor

    t_phase = time.perf_counter()
    geom = get_problem("P5").geometry()
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.random(geom.proj_shape_hw,
                                    dtype=np.float32)).cuda()
    total = {k: 0 for k in launches()}

    def counted(fn):
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        n = launches()
        for k, v in n.items():
            total[k] += v
        return out, {k: v for k, v in n.items() if v}

    def candidates(label):
        rows = [e["args"] for e in _span_events("autotune.candidate")]
        for a in rows:
            print(f"[tune] {label} candidate {a['key']}: "
                  f"{a['wall_us'] / 1e3:.3f} ms")
        return rows

    tmp = tempfile.TemporaryDirectory()
    path = os.path.join(tmp.name, "tuning.json")
    print(f"[tune] fingerprint {at.fingerprint_key()}")

    # (a) the plain version
    t0 = time.perf_counter()
    base, n = counted(lambda: repro_torch.reconstruct(
        p, geom, variant="algorithm1_mp"))
    base_s = time.perf_counter() - t0
    print(f"[tune] (a) reconstruct algorithm1_mp (the plain version; the "
          f"CPU's heuristic base of 'auto') at P5: {base_s * 1e3:.3f} ms, "
          f"one run, host clock to a synchronize; launches {n}")
    require(not n, "algorithm1_mp launched a kernel")

    # (b) the wide search, with the tuner's default budget and iters
    untuned = at.resolve_config(geom, "auto", cache=path)
    print(f"[tune] (b) untuned 'auto' plans {untuned.variant} "
          f"({untuned.source})")
    require(untuned.source == "heuristic"
            and untuned.variant == CUDA_VARIANTS[0],
            "untuned 'auto' does not plan the card's ladder head")
    t0 = time.perf_counter()
    with telemetry.tracing():
        cfg, n = counted(lambda: at.autotune(
            geom, "auto", variants=CUDA_VARIANTS, cache=path))
    rows = candidates("(b)")
    print(f"[tune] (b) autotune(auto) {time.perf_counter() - t0:.1f} s: "
          f"winner {cfg.key}, {cfg.wall_us / 1e3:.3f} ms against the "
          f"baseline's {cfg.baseline_us / 1e3:.3f} ms, speedup "
          f"{cfg.speedup:.3f}, trials {cfg.trials}; launches {n}")
    measured = {a["variant"] for a in rows}
    require(set(CUDA_VARIANTS) <= measured,
            f"the tuner did not measure every CUDA variant: {measured}")
    for variant in CUDA_VARIANTS:
        require(n.get(VARIANT_KERNELS[variant][0], 0) > 0,
                f"the search never launched {VARIANT_KERNELS[variant][0]}")

    # (c) resolve with zero measurements
    calls = []
    orig = at._measure_config
    at._measure_config = lambda *a, **k: calls.append(1) or orig(*a, **k)
    res = at.resolve_config(geom, "auto", cache=path)
    vol, n = counted(lambda: repro_torch.reconstruct(
        p, geom, options=ReconOptions(variant="auto", tuning=path)))
    at._measure_config = orig
    f32 = cfg.precision == "f32"
    bar = BAR if f32 else BF16_CONTRACT
    r = rel_rmse(vol, base)
    print(f"[tune] (c) reconstruct(variant='auto', tuning=path): "
          f"{len(calls)} measurements, resolved {res.source}; launches {n}; "
          f"rel_rmse {r:.3e} vs algorithm1_mp (bar {bar:g}: the "
          f"{'f32' if f32 else 'bf16'} contract)")
    require(not calls and res.source == "cache" and res.key == cfg.key,
            "the tuned reconstruct measured or missed the cache")
    if cfg.variant in VARIANT_KERNELS:
        require(sum(n.get(k, 0) for k in VARIANT_KERNELS[cfg.variant]) > 0,
                f"the tuned reconstruct never launched {cfg.variant}")
    require(tuple(vol.shape) == geom.volume_shape_zyx and r < bar,
            "the tuned reconstruct disagrees with algorithm1_mp")
    del vol, base

    # (d) exact mode: order-only knobs, bit for bit
    t0 = time.perf_counter()
    tiled = dict(tiling=(256, 256, 96), out="host")
    with telemetry.tracing():
        cfg_d, n = counted(lambda: at.autotune(
            geom, "subline_pl", iters=1, cache=path, **tiled))
    candidates("(d)")
    heur = repro_torch.reconstruct(p, geom, variant="subline_pl", **tiled)
    tuned = PlanExecutor.from_config(geom, cfg_d).reconstruct(p)
    same = bool(np.array_equal(heur, tuned))
    print(f"[tune] (d) exact autotune(subline_pl, tiling=(256, 256, 96), "
          f"out=host) {time.perf_counter() - t0:.1f} s: winner schedule "
          f"{cfg_d.schedule}, pipeline {cfg_d.pipeline} depth "
          f"{cfg_d.pipeline_depth}, {cfg_d.wall_us / 1e3:.3f} ms against "
          f"{cfg_d.baseline_us / 1e3:.3f} ms, trials {cfg_d.trials}; "
          f"launches {n}; tuned volume bitwise equal to the heuristic: "
          f"{same}")
    require(same and cfg_d.variant == "subline_pl"
            and cfg_d.tile_shape == (256, 256, 96)
            and cfg_d.precision == "f32",
            "exact-mode tuning is not bit-identical to the heuristic")
    del heur, tuned

    # (e) a second process resolves the same cache
    child = json.dumps({"src": str(ROOT / "src"),
                        "variants": list(CUDA_VARIANTS), "path": path})
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", SECOND_PROCESS, child],
                         check=True, capture_output=True, text=True,
                         timeout=300)
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("RESULT:")][-1]
    second = json.loads(line[len("RESULT:"):])
    print(f"[tune] (e) second process ({time.perf_counter() - t0:.1f} s): "
          f"{second}")
    require(second["measured"] == 0 and second["trials"] == 0
            and second["source"] == second["resolved"] == "cache"
            and second["key"] == second["resolved_key"] == repr(cfg.key),
            "the second process did not hit the cache")

    # (f) a SART tune
    t0 = time.perf_counter()
    with telemetry.tracing():
        cfg_f, n = counted(lambda: at.autotune(
            geom, "subline_pl", method="sart", iters=1,
            budget_s=SART_TUNE_BUDGET_S, cache=path))
    candidates("(f) sart, per iteration,")
    print(f"[tune] (f) autotune(subline_pl, method='sart') "
          f"{time.perf_counter() - t0:.1f} s: winner {cfg_f.key}, "
          f"{cfg_f.wall_us / 1e3:.3f} ms per iteration against the "
          f"baseline's {cfg_f.baseline_us / 1e3:.3f} ms, speedup "
          f"{cfg_f.speedup:.3f}, trials {cfg_f.trials}; launches {n}")
    require(cfg_f.solver == "sart" and n.get(F1, 0) > 0
            and n.get("backproject_subline_fused", 0) > 0,
            "the SART tune did not launch F1 and K2")
    telemetry.clear()
    tmp.cleanup()
    del p
    torch.cuda.empty_cache()
    print(f"[tune] launches over the phase: "
          f"{ {k: v for k, v in total.items() if v} }")
    print(f"[tune] phase {time.perf_counter() - t_phase:.1f} s")
    return total


# --------------------------------------------------------------------------
# [batch], [stream], [service]: request batching, streaming and serving
# --------------------------------------------------------------------------

LANE_RB = 3                       # rb of the lane sweep
LANE_RB_P5 = 4                    # rb of execute_batch and lane_ms at P5
LANE_SWEEP = SWEEP                # the sweep's shapes, (13, 17, 5) with them
# the lane form of each kernel's launch counter
LANES = {name: f"{name}_lanes" for name in KERNELS}
BATCH_VARIANTS = (("subline_pl", 8), ("subline_pl", 1), ("onehot_pl", 8),
                  ("onehot_pl", 1), ("banded_pl", 8), ("banded_pl", 1))
STREAM_CHUNK = 128                # views a chunk of the P5 stream
SCAN_S = 1.0                      # the paced scanner: 512 views in 1 s
SCAN_GROUP = 16                   # views a push
BATCH_BUDGETS = (4 << 30, 16 << 30)   # the rb = 8 tile picker at P5


def lane_launches() -> dict:
    """The lane launches of K1-K6 since the last reset, by kernel row."""
    n = launches()
    return {name: n[lane] for name, lane in LANES.items()}


def _lane_sweep_case(geom, seed, errs) -> int:
    """K1-K6 lane launches (rb = LANE_RB) against the solo launches (bit
    for bit) and the plain versions (the sweep's bars), K5/K6 also on
    shifted bands that drop lines; returns the lane cases checked."""
    import numpy as np
    import torch
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels import ops
    ks, ko, kb = launch_modules()
    npj = geom.n_proj
    rng = np.random.RandomState(seed)
    img_b = torch.stack([transpose_projections(torch.from_numpy(
        rng.rand(npj, geom.nh, geom.nw).astype(np.float32)).cuda())
        for _ in range(LANE_RB)])
    mats = projection_matrices(geom)
    shape = geom.volume_shape_xyz
    pshape = (-(-shape[0] // 4) * 4, -(-shape[1] // 8) * 8, shape[2])
    families = (("subline", ops.backproject_subline_lanes,
                 ops.backproject_subline, SUBLINE_PLAIN_BAR),
                ("onehot", ops.backproject_onehot_lanes,
                 ops.backproject_onehot, ONEHOT_PLAIN_BAR),
                ("banded", ops.backproject_banded_lanes,
                 ops.backproject_banded, BAR))

    def plain_of(family, x, nb, loop):
        """The family's plain version on the card, as the sweep holds it."""
        if family == "subline":
            return ks.backproject_subline_plain(x, mats, shape)
        if family == "onehot":
            return ko.backproject_onehot_plain(x, mats, shape)
        group = nb if ks.fused_batch_ok(npj, nb, loop) else 1
        img_x, band, bw = kb.band_schedule(x, mats, pshape, block=(4, 8),
                                           bw=32, group=group)
        return kb.backproject_banded_plain(
            img_x, mats, band, pshape, block=(4, 8), bw=bw, nw=geom.nw,
            group=group)[:shape[0], :shape[1]]

    n = 0
    for family, lanes, solo, bar in families:
        for nb, loop in ((1, False), (npj, True)):
            kernel = (f"backproject_{family}_fused" if loop
                      else f"backproject_{family}_kernel")
            out = lanes(img_b, mats, shape, nb=nb, proj_loop=loop)
            for r in range(LANE_RB):
                one = solo(img_b[r], mats, shape, nb=nb, proj_loop=loop)
                require(torch.equal(out[r], one), f"lane {r} of the "
                        f"{kernel} lane launch at {shape} is not bitwise "
                        f"equal to its solo launch")
                plain = plain_of(family, img_b[r], nb, loop)
                err = rel_rmse(out[r], plain)
                errs[kernel] = max(errs[kernel],
                                   float((out[r] - plain).abs().max()))
                require(err < bar, f"lane {r} of {kernel} at {shape}: "
                        f"{err:.2e} from its plain version (bar {bar})")
                n += 1
    # K5/K6 lanes on bands of SHIFT_BW columns moved one place right: lines
    # are dropped, as in the solo sweep's shifted case
    img_bb = kb.band_layout_lanes(img_b, SHIFT_BW)
    n_bands = img_bb.shape[2]
    k1 = ks.backproject_subline_kernel_lanes(img_b, mats, pshape)
    dropped = False
    for group in (1, npj):
        band, _ = kb.tile_bands(mats, *pshape[:2], 4, 8, SHIFT_BW, n_bands,
                                geom.nw, group=group)
        band = torch.clamp(band + 1, max=n_bands - 1)
        kw = dict(block=(4, 8), bw=SHIFT_BW, nw=geom.nw)
        if group == 1:
            kernel = "backproject_banded_kernel"
            out = kb.backproject_banded_kernel_lanes(img_bb, mats, band,
                                                     pshape, **kw)
        else:
            kernel = "backproject_banded_fused"
            out = kb.backproject_banded_fused_lanes(img_bb, mats, band,
                                                    pshape, nb=group, **kw)
        for r in range(LANE_RB):
            plain = kb.backproject_banded_plain(img_bb[r], mats, band,
                                                pshape, group=group, **kw)
            err = rel_rmse(out[r], plain)
            errs[kernel] = max(errs[kernel],
                               float((out[r] - plain).abs().max()))
            require(err < BAR, f"shifted-band lane {r} of {kernel}: "
                    f"{err:.2e} from its plain version")
            solo = (kb.backproject_banded_kernel(img_bb[r], mats, band,
                                                 pshape, **kw)
                    if group == 1 else
                    kb.backproject_banded_fused(img_bb[r], mats, band,
                                                pshape, nb=group, **kw))
            require(torch.equal(out[r], solo), f"shifted-band lane {r} of "
                    f"{kernel} is not bitwise equal to its solo launch")
            dropped |= not torch.equal(out[r], k1[r])
            n += 1
    require(dropped, f"the shifted bands dropped no line at {shape}")
    return n


def phase_batch(seed: int, errs: dict, plain) -> tuple:
    """The rb-lane launch of K1-K6 and ``PlanExecutor.execute_batch`` at
    P5. Returns (lane launches of the phase's main-path runs by kernel
    row, per-lane ms of an rb = LANE_RB_P5 lane launch at P5)."""
    import numpy as np
    import torch
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.filtering import fdk_filter_chunk
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.geometry import standard_geometry
    from repro_torch.kernels import ops
    from repro_torch.runtime.executor import PlanExecutor
    from repro_torch.runtime.planner import plan_reconstruction
    ks, ko, kb = launch_modules()
    t_phase = time.perf_counter()
    card = card_line()

    # (a) the lane sweep
    n = 0
    for i, (nn, det, npj) in enumerate(LANE_SWEEP):
        n += _lane_sweep_case(standard_geometry(n=nn, n_det=det, n_proj=npj),
                              seed + 100 + i, errs)
    print(f"[batch] lane sweep, rb={LANE_RB}: {n} lanes of K1-K6 on "
          f"{len(LANE_SWEEP)} shapes (odd nz (13, 17, 5) among them, and "
          f"shifted bands that drop lines) equal their solo launches bit for "
          f"bit and their plain versions within the sweep's bars")

    # (b) each lane at P5 equals its solo launch, and the lane launch's time
    geom = get_problem("P5").geometry()
    shape = geom.volume_shape_xyz
    rng = np.random.default_rng(seed + 7)
    reqs = [torch.from_numpy(rng.random(geom.proj_shape_hw,
                                        dtype=np.float32)).cuda()
            for _ in range(LANE_RB_P5)]
    mats = projection_matrices(geom)
    img_b = torch.stack([transpose_projections(
        fdk_filter_chunk(p, geom, geom.n_proj)) for p in reqs])
    lane_calls = {
        "backproject_subline_kernel": lambda x: ops.backproject_subline_lanes(
            x, mats, shape, nb=1),
        "backproject_subline_fused": lambda x: ops.backproject_subline_lanes(
            x, mats, shape, nb=8, proj_loop=True),
        "backproject_onehot_kernel": lambda x: ops.backproject_onehot_lanes(
            x, mats, shape, nb=1),
        "backproject_onehot_fused": lambda x: ops.backproject_onehot_lanes(
            x, mats, shape, nb=8, proj_loop=True),
        "backproject_banded_kernel": lambda x: ops.backproject_banded_lanes(
            x, mats, shape, nb=1),
        "backproject_banded_fused": lambda x: ops.backproject_banded_lanes(
            x, mats, shape, nb=8, proj_loop=True)}
    solo_calls = {
        "backproject_subline_kernel": lambda x: ops.backproject_subline(
            x, mats, shape, nb=1),
        "backproject_subline_fused": lambda x: ops.backproject_subline(
            x, mats, shape, nb=8, proj_loop=True),
        "backproject_onehot_kernel": lambda x: ops.backproject_onehot(
            x, mats, shape, nb=1),
        "backproject_onehot_fused": lambda x: ops.backproject_onehot(
            x, mats, shape, nb=8, proj_loop=True),
        "backproject_banded_kernel": lambda x: ops.backproject_banded(
            x, mats, shape, nb=1),
        "backproject_banded_fused": lambda x: ops.backproject_banded(
            x, mats, shape, nb=8, proj_loop=True)}
    lane_ms = {}
    for name in KERNELS:
        out = lane_calls[name](img_b[:2])
        for r in range(2):
            require(torch.equal(out[r], solo_calls[name](img_b[r])),
                    f"lane {r} of the {name} lane launch at P5, rb=2, is "
                    f"not bitwise equal to its solo launch")
        del out
        ms = timed(lambda: lane_calls[name](img_b))
        solo_ms = timed(lambda: solo_calls[name](img_b[0]))
        lane_ms[name] = ms / LANE_RB_P5
        print(f"[batch] P5 {KERNELS[name][0]}: lanes equal solo bit for "
              f"bit (rb=2); rb={LANE_RB_P5} lane launch {ms:.3f} ms, "
              f"{lane_ms[name]:.3f} ms a lane, solo launch {solo_ms:.3f} ms "
              f"(median of 3 after a warm-up; {card})")
    del img_b

    # (c) execute_batch at P5, rb = LANE_RB_P5, through each CUDA variant
    batch = {name: 0 for name in KERNELS}
    for variant, nb in BATCH_VARIANTS:
        plan = plan_reconstruction(geom, variant, nb=nb,
                                   proj_batch=STREAM_CHUNK, out="device")
        ex = PlanExecutor(geom, plan)
        solo = [ex.reconstruct(p) for p in reqs]
        reset_launches()
        plain.calls = 0
        vols = ex.execute_batch(reqs)
        torch.cuda.synchronize()
        got = lane_launches()
        n_all = sum(launches().values())
        kernel = max(got, key=got.get)
        want = len(plan.steps) * len(plan.chunks)
        require(got[kernel] == want and n_all == want and plain.calls == 0,
                f"execute_batch {variant} nb={nb}: launches {launches()}, "
                f"want {want} lane launches of one kernel (steps x chunks) "
                f"and no plain version")
        for name in KERNELS:
            batch[name] += got[name]
        for r in range(LANE_RB_P5):
            require(tuple(vols[r].shape) == geom.volume_shape_zyx
                    and torch.equal(vols[r], solo[r]),
                    f"execute_batch {variant} nb={nb}: lane {r} is not "
                    f"bitwise equal to reconstruct on that request")
        line = (f"[batch] P5 execute_batch {variant} nb={nb}, "
                f"rb={LANE_RB_P5}: every lane equals its solo reconstruct "
                f"bit for bit; {want} lane launches of {kernel} (1 step x "
                f"{len(plan.chunks)} chunks) for {LANE_RB_P5} requests")
        if nb == 8:
            ms_b = timed(lambda: ex.execute_batch(reqs))
            ms_s = timed(lambda: [ex.reconstruct(p) for p in reqs])
            line += (f"; batch {ms_b:.3f} ms vs {LANE_RB_P5} sequential "
                     f"reconstruct {ms_s:.3f} ms ({ms_s / ms_b:.3f}x; median "
                     f"of 3 after a warm-up; {card})")
        print(line)
        del vols, solo
    require(all(batch[name] > 0 for name in KERNELS),
            f"execute_batch launched no lane form of some kernel: {batch}")

    # (d) the tiled walks at P5, rb = 2: host async (the service's bucket)
    # and device sync (the slab steps without the host flush)
    for out, pipeline in (("host", "async"), ("device", "sync")):
        plan = plan_reconstruction(geom, "subline_pl",
                                   tile_shape=(256, 256, 96),
                                   proj_batch=STREAM_CHUNK, out=out)
        ex = PlanExecutor(geom, plan, pipeline=pipeline)
        solo = [ex.reconstruct(p) for p in reqs[:2]]
        reset_launches()
        plain.calls = 0
        vols = ex.execute_batch(reqs[:2])
        torch.cuda.synchronize()
        got = lane_launches()
        want = len(plan.steps) * len(plan.chunks)
        label = f"tiled (256, 256, 96) out={out} {pipeline}"
        require(got["backproject_subline_fused"] == want
                and sum(launches().values()) == want and plain.calls == 0,
                f"{label} execute_batch: launches {launches()}, want {want}")
        for name in KERNELS:
            batch[name] += got[name]
        for r in range(2):
            same = (np.array_equal(vols[r], solo[r]) if out == "host"
                    else torch.equal(vols[r], solo[r]))
            require(same, f"{label} execute_batch lane {r} is not bitwise "
                    f"equal to solo")
        del vols, solo
        ms_b = timed(lambda: ex.execute_batch(reqs[:2]))
        ms_s = timed(lambda: [ex.reconstruct(p) for p in reqs[:2]])
        print(f"[batch] P5 {label} execute_batch rb=2: both lanes equal "
              f"solo bit for bit; {want} lane launches = {len(plan.steps)} "
              f"steps x {len(plan.chunks)} chunks; batch {ms_b:.3f} ms vs 2 "
              f"sequential {ms_s:.3f} ms ({ms_s / ms_b:.3f}x; median of 3 "
              f"after a warm-up; {card})")
    for budget in BATCH_BUDGETS:
        rb8 = plan_reconstruction(geom, "subline_pl", memory_budget=budget,
                                  request_batch=8)
        print(f"[batch] P5 memory_budget={budget / 2**30:g} GiB at "
              f"request_batch=8: the tile picker plans {rb8.tile_shape} "
              f"({len(rb8.steps)} steps), working set "
              f"{rb8.working_set_bytes / 2**30:.3f} GiB for 8 lanes")
        require(rb8.working_set_bytes <= budget,
                "the rb=8 plan overruns its memory budget")
    del reqs
    print(f"[batch] phase {time.perf_counter() - t_phase:.1f} s")
    return batch, lane_ms


def _pace(sessions, projs, t_start) -> None:
    """Push the scan's views to each session in SCAN_GROUP groups at the
    paced scanner's rate (all sessions in lockstep)."""
    n = projs[0].shape[0]
    for v0 in range(0, n, SCAN_GROUP):
        wait = t_start + SCAN_S * v0 / n - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        for sess, p in zip(sessions, projs):
            sess.push(p[v0:v0 + SCAN_GROUP], start=v0)


def phase_stream(seed: int, plain) -> dict:
    """Online ingest at P5: a producer thread pushes the 512 views at a
    paced scanner rate (SCAN_S seconds a rotation) into one session, then
    into two sessions of one service folded as one lane launch per step.
    Returns the lane launches of the two runs by kernel row."""
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.runtime.executor import PlanExecutor
    from repro_torch.runtime.planner import plan_reconstruction
    from repro_torch.runtime.service import ReconService
    t_phase = time.perf_counter()
    card = card_line()
    geom = get_problem("P5").geometry()
    rng = np.random.default_rng(seed + 11)
    projs = [rng.random(geom.proj_shape_hw, dtype=np.float32)
             for _ in range(2)]
    plan = plan_reconstruction(geom, "subline_pl", proj_batch=STREAM_CHUNK,
                               ingest="stream", out="device")
    ex = PlanExecutor(geom, plan)
    refs = [ex.reconstruct(p) for p in projs]
    total = {name: 0 for name in KERNELS}

    def run(sessions, data):
        reset_launches()
        plain.calls = 0
        # the scanner: a thread of its own, whose error result() raises
        with ThreadPoolExecutor(1, thread_name_prefix="scanner") as pool:
            pool.submit(_pace, sessions, data, time.perf_counter()).result()
        vols = [s.close() for s in sessions]
        torch.cuda.synchronize()
        require(plain.calls == 0, "a stream fold ran a plain version")
        return vols

    # one session on the executor: its own folder thread
    se = ex.open_stream()
    (vol,) = run([se], projs[:1])
    n = launches()
    require(n["backproject_subline_fused"] == len(plan.chunks)
            and sum(n.values()) == len(plan.chunks),
            f"one stream: launches {n}, want {len(plan.chunks)} of K2")
    require(torch.equal(vol, refs[0]), "the P5 stream is not bitwise equal "
            "to the chunk-major reconstruct")
    rep = se.report
    print(f"[stream] P5 subline_pl, {len(plan.chunks)} chunks of "
          f"{STREAM_CHUNK} views pushed over {rep.acquire_s * 1e3:.3f} ms "
          f"(paced, {SCAN_GROUP} views a push): close() equals the "
          f"chunk-major reconstruct bit for bit; compute "
          f"{rep.compute_s * 1e3:.3f} ms, tail (last view to volume) "
          f"{rep.tail_s * 1e3:.3f} ms, hidden_fraction "
          f"{rep.hidden_fraction:.3f} ({card})")

    # two sessions of one service, folded as one lane launch per step
    with ReconService(max_inflight=1, max_batch=2, max_wait_ms=200.0) as svc:
        sessions = [svc.open_stream(geom, variant="subline_pl",
                                    proj_batch=STREAM_CHUNK, out="device")
                    for _ in range(2)]
        vols = run(sessions, projs)
        got = lane_launches()
        st = next(b for b in svc.stats().buckets if b.streams)
    for name in KERNELS:
        total[name] += got[name]
    for r in range(2):
        require(torch.equal(vols[r], refs[r]), f"session {r} of two is not "
                f"bitwise equal to its solo stream")
    require(st.stream_dispatches == len(plan.chunks)
            and st.stream_mean_lanes == 2.0
            and got["backproject_subline_fused"] == len(plan.chunks),
            f"two sessions: {st.stream_dispatches} stream dispatches, "
            f"{st.stream_mean_lanes} lanes each, lane launches {got}; want "
            f"{len(plan.chunks)} dispatches of 2 lanes, one lane launch "
            f"each")
    print(f"[stream] two concurrent P5 sessions: {st.stream_dispatches} "
          f"service.stream_dispatch of {st.stream_mean_lanes} lanes, "
          f"{got['backproject_subline_fused']} lane launches of K2; each "
          f"session equals its solo stream bit for bit; mean tail "
          f"{st.stream_tail_ms} ms, mean hidden_fraction "
          f"{st.stream_hidden_fraction} ({card})")
    print(f"[stream] phase {time.perf_counter() - t_phase:.1f} s")
    return total


SERVICE_BUCKETS = (("untiled device", dict(variant="subline_pl")),
                   ("(256, 256, 96) host async",
                    dict(variant="subline_pl", tiling=(256, 256, 96),
                         proj_batch=STREAM_CHUNK)))


def phase_service(seed: int, plain) -> dict:
    """``ReconService(max_inflight=2, max_batch=4)`` at P5: two warmed
    buckets, a burst of 8 requests across them, each result against its
    solo reconstruct, no program built after warm-up; and
    ``repro_torch.reconstruct(..., service=svc)``. Returns the burst's
    lane launches by kernel row."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import ReconOptions
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.runtime import telemetry
    from repro_torch.runtime.service import ReconService
    t_phase = time.perf_counter()
    card = card_line()
    geom = get_problem("P5").geometry()
    rng = np.random.default_rng(seed + 13)
    reqs = [torch.from_numpy(rng.random(geom.proj_shape_hw,
                                        dtype=np.float32)).cuda()
            for _ in range(4)]
    total = {name: 0 for name in KERNELS}
    with ReconService(max_inflight=2, max_batch=4) as svc:
        t0 = time.perf_counter()
        stats = svc.warmup([geom], **SERVICE_BUCKETS[0][1])
        stats = svc.warmup([geom], **SERVICE_BUCKETS[1][1])
        print(f"[service] warm-up of {len(stats.buckets)} P5 buckets: "
              f"{stats.cache['misses']} programs built in "
              f"{time.perf_counter() - t0:.3f} s")
        solo, buckets = {}, {}
        for label, opts in SERVICE_BUCKETS:
            plan = svc._plan(geom, opts)[0]
            buckets[label] = svc._buckets[(geom, plan.bucket_key)]
            solo[label] = [buckets[label].executor.reconstruct(p)
                           for p in reqs]
        torch.cuda.synchronize()
        misses = svc.cache.stats()["misses"]
        reset_launches()
        plain.calls = 0
        with telemetry.tracing():
            t0 = time.perf_counter()
            futs = [(label, r, svc.submit(reqs[r], geom, **opts))
                    for r in range(4) for label, opts in SERVICE_BUCKETS]
            outs = [(label, r, f.result()) for label, r, f in futs]
            wall = time.perf_counter() - t0
            compiles = sum(e["name"] == "compile"
                           for e in telemetry.events())
        got = lane_launches()
        require(compiles == 0 and svc.cache.stats()["misses"] == misses,
                f"{compiles} programs were built after warm-up")
        require(plain.calls == 0, "a served request ran a plain version")
        for label, r, vol in outs:
            want = solo[label][r]
            same = (np.array_equal(vol, want) if isinstance(want, np.ndarray)
                    else torch.equal(vol, want))
            require(same, f"served request {r} of {label} is not bitwise "
                    f"equal to its solo reconstruct")
        st = svc.stats()
        print(f"[service] burst of 8 P5 requests over 2 buckets in "
              f"{wall * 1e3:.3f} ms (host clock): each equals its solo "
              f"reconstruct bit for bit, 0 programs built after warm-up; "
              f"lane launches {got}; {card}")
        for label, bucket in buckets.items():
            b = bucket.snapshot()
            print(f"[service]   bucket {label} ({b.variant}, out="
                  f"{bucket.plan.out}): {b.completed} requests in "
                  f"{b.dispatches} batches, occupancy {b.mean_occupancy}, "
                  f"p50 {b.p50_ms} ms, p99 {b.p99_ms} ms, batch p50 "
                  f"{b.batch_p50_ms} ms, {b.amortized_us_per_request} us "
                  f"a request (host clock; {card})")
        require(st.dispatches < 8, f"the burst formed no batch: "
                f"{st.dispatches} dispatches for 8 requests")
        for name in KERNELS:
            total[name] += got[name]
        hits = st.bucket_hits
        via = repro_torch.reconstruct(reqs[0], geom, options=ReconOptions(
            service=svc, **SERVICE_BUCKETS[0][1]))
        require(svc.stats().bucket_hits == hits + 1
                and torch.equal(via, solo[SERVICE_BUCKETS[0][0]][0]),
                "reconstruct(service=svc) was not routed through the bucket")
        print("[service] repro_torch.reconstruct(..., service=svc) routed "
              "through the untiled bucket, equal to its solo reconstruct")
    print(f"[service] phase {time.perf_counter() - t_phase:.1f} s")
    return total


# the fleet's P5 walk: TILED_P5 with a host volume, step-major (12 steps x
# 4 chunks); entry 0 of the straggler run sleeps this long before each step
FLEET_STRAGGLE_S = 0.5
NONFUSED = {"subline_pl": "backproject_subline_kernel",
            "onehot_pl": "backproject_onehot_kernel",
            "banded_pl": "backproject_banded_kernel"}


def _fleet_walk(label, geom, plan, p, cfg, kernel, plain, want):
    """One checked fleet run: the volume equals ``want`` (the single-device
    step-major host walk) bit for bit, with one launch of ``kernel`` per
    step and chunk, no other kernel and no plain version. Returns the
    executor (its ``last_fleet_report``) and the launches."""
    import numpy as np
    import torch
    from repro_torch.runtime.executor import PlanExecutor
    ex = PlanExecutor(geom, plan, fleet=cfg)
    ex.warm()
    torch.cuda.synchronize()
    reset_launches()
    plain.calls = 0
    vol = ex.reconstruct(p)
    n = launches()
    want_n = len(plan.steps) * len(plan.chunks)
    require(n[kernel] == want_n and sum(n.values()) == want_n,
            f"{label}: launches {n}, want {want_n} of {kernel}")
    require(plain.calls == 0, f"{label}: a plain version ran")
    require(np.array_equal(vol, want), f"{label} is not bitwise equal to "
            f"the single-device step-major host walk")
    rep = ex.last_fleet_report
    require(sum(rep.steps_by_device) == len(plan.steps),
            f"{label}: steps by entry {rep.steps_by_device}")
    return ex, n[kernel]


def phase_fleet(seed: int, plain, walls) -> dict:
    """The reconstruction fleet at P5 on the tiled host walk (TILED_P5, 12
    steps x 4 chunks of 128 views), for each CUDA variant at nb = 8: fleets
    of ("cuda:0",) and ("cuda:0",) * 2, failover (entry 1 faults and is
    retired with 0 steps), a straggler (entry 0 sleeps, steps are stolen)
    each equal to the single-device step-major host walk bit for bit; a
    poison step aborts; ``ReconService(devices=("cuda:0",) * 2)`` serves
    two requests, and ``execute_batch`` runs them as rb = 2 lane steps on
    that fleet, each its solo walk bit for bit; and at nb = 1 a fleet of
    two (K1, K3, K5). Prints the fleets' host walls beside the step host
    walls of [tiled]. One card shows the fleet's correctness and what its
    threads cost, not scaling across cards. Returns the checked runs'
    launches by kernel row (lane launches in their kernel's row)."""
    import concurrent.futures
    import numpy as np
    import torch
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.fdk import _build_plan
    from repro_torch.runtime.executor import FleetConfig, PlanExecutor
    from repro_torch.runtime.service import ReconService
    t_phase = time.perf_counter()
    card = card_line()
    geom = get_problem("P5").geometry()
    rng = np.random.default_rng(seed + 17)
    p, p2 = (torch.from_numpy(rng.random(geom.proj_shape_hw,
                                         dtype=np.float32)).cuda()
             for _ in range(2))
    one, two = ("cuda:0",), ("cuda:0",) * 2
    total = {name: 0 for name in KERNELS}

    def plan_of(variant, nb):
        return _build_plan(geom, variant, nb=nb, interpret=True,
                           tiling=TILED_P5["tiling"], memory_budget=None,
                           proj_batch=TILED_P5["proj_batch"], out="host",
                           schedule="step")

    def fail_entry1(entry, step):
        if entry == 1:
            raise RuntimeError("injected device fault")

    def straggle_entry0(entry, step):
        if entry == 0:
            time.sleep(FLEET_STRAGGLE_S)

    def poison_step0(entry, step):
        if step == 0:
            raise RuntimeError("injected poison step")

    for variant, kernel in FUSED.items():
        plan = plan_of(variant, 8)
        require(len(plan.steps) == TILED_P5_STEPS and len(plan.chunks) == 4,
                f"P5 fleet plan: {len(plan.steps)} steps x "
                f"{len(plan.chunks)} chunks")
        single = PlanExecutor(geom, plan).reconstruct(p)
        label = f"P5 {variant} fleet"
        fwalls, reps = {}, {}
        for name, cfg in (("of 1", FleetConfig(devices=one)),
                          ("of 2", FleetConfig(devices=two)),
                          ("failover", FleetConfig(devices=two,
                                                   step_hook=fail_entry1)),
                          ("straggler", FleetConfig(
                              devices=two, step_hook=straggle_entry0))):
            ex, n = _fleet_walk(f"{label} {name}", geom, plan, p, cfg,
                                kernel, plain, single)
            total[kernel] += n
            reps[name] = rep = ex.last_fleet_report
            if name in ("of 1", "of 2"):
                runs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    ex.reconstruct(p)
                    runs.append((time.perf_counter() - t0) * 1e3)
                fwalls[name] = statistics.median(runs)
        fo, st = reps["failover"], reps["straggler"]
        require(fo.dead_devices == (1,) and fo.steps_by_device[1] == 0
                and fo.retried >= 1, f"{label} failover: {fo}")
        require(st.stolen >= 1, f"{label} straggler: nothing stolen: {st}")
        ex = PlanExecutor(geom, plan, fleet=FleetConfig(
            devices=two, step_hook=poison_step0))
        ex.warm()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            err = pool.submit(ex.reconstruct, p).exception()
        require(isinstance(err, RuntimeError)
                and "max_retries_per_step" in str(err)
                and "injected poison step" in str(err.__cause__),
                f"{label} poison step did not abort: {err!r}")
        print(f"[fleet] {label} (256, 256, 96) host, {len(plan.steps)} "
              f"steps x {len(plan.chunks)} chunks: of 1 {fwalls['of 1']:.3f} ms, of 2 {fwalls['of 2']:.3f} ms "
              f"(host clock, median of 3 after the checked run); step host "
              f"sync {walls[(variant, 'step', 'host', 'sync')]:.3f} ms, "
              f"async {walls[(variant, 'step', 'host', 'async')]:.3f} ms "
              f"([tiled], CUDA events); each bitwise equal to the single "
              f"walk; steps by entry: of 2 {reps['of 2'].steps_by_device}, "
              f"failover {fo.steps_by_device} (retired {fo.dead_devices}, "
              f"{fo.retried} re-run), straggler {st.steps_by_device} "
              f"({st.stolen} stolen, flagged {st.flagged_devices}); poison "
              f"step aborted; {card}")
        solo2 = PlanExecutor(geom, plan).reconstruct(p2)
        with ReconService(max_inflight=2, devices=two) as svc:
            opts = dict(variant=variant, tiling=TILED_P5["tiling"],
                        proj_batch=TILED_P5["proj_batch"])
            svc.warmup([geom], **opts)
            torch.cuda.synchronize()
            reset_launches()
            plain.calls = 0
            futs = [svc.submit(x, geom, **opts) for x in (p, p2)]
            outs = [f.result() for f in futs]
            n = launches()
            row = svc.stats().buckets[0]
        want_n = 2 * len(plan.steps) * len(plan.chunks)
        require(n[kernel] == want_n and sum(n.values()) == want_n
                and plain.calls == 0,
                f"{label} service: launches {n}, want {want_n} of {kernel}")
        require(np.array_equal(outs[0], single)
                and np.array_equal(outs[1], solo2),
                f"{label} service: a request differs from its solo walk")
        require(row.devices == 2 and row.completed == 2,
                f"{label} service bucket: {row}")
        total[kernel] += n[kernel]
        print(f"[fleet] {label} service (devices=('cuda:0',) * 2): 2 "
              f"requests, each bitwise equal to its solo walk; bucket "
              f"devices {row.devices}, steals {row.steals}, failovers "
              f"{row.failovers}")
        # the batched fleet: one rb = 2 lane launch a step and chunk
        ex = PlanExecutor(geom, plan, fleet=FleetConfig(devices=two))
        ex.warm_batch(2)
        torch.cuda.synchronize()
        reset_launches()
        plain.calls = 0
        outs = ex.execute_batch([p, p2])
        n = launches()
        want_n = len(plan.steps) * len(plan.chunks)
        require(n[LANES[kernel]] == want_n and sum(n.values()) == want_n
                and plain.calls == 0,
                f"{label} batch: launches {n}, want {want_n} of "
                f"{LANES[kernel]}")
        require(np.array_equal(outs[0], single)
                and np.array_equal(outs[1], solo2),
                f"{label} batch: a lane differs from its solo walk")
        total[kernel] += n[LANES[kernel]]
        print(f"[fleet] {label} execute_batch of 2 on ('cuda:0',) * 2: "
              f"each lane bitwise equal to its solo walk, {want_n} launches "
              f"of {LANES[kernel]}, steps by entry "
              f"{ex.last_fleet_report.steps_by_device}")
        del single, solo2, outs
        nb1 = plan_of(variant, 1)
        single = PlanExecutor(geom, nb1).reconstruct(p)
        ex, n = _fleet_walk(f"{label} nb=1 of 2", geom, nb1, p,
                            FleetConfig(devices=two), NONFUSED[variant],
                            plain, single)
        total[NONFUSED[variant]] += n
        print(f"[fleet] {label} nb=1 of 2: bitwise equal to the single "
              f"walk, {n} launches of {NONFUSED[variant]}")
        del single
    print(f"[fleet] launches of the checked runs: {total}")
    print(f"[fleet] phase {time.perf_counter() - t_phase:.1f} s")
    return total


# --------------------------------------------------------------------------
# mesh-sharded back-projection and the CT projection source
# --------------------------------------------------------------------------

DIST_PROBLEM = "P5"               # the mesh walks' problem (random views)
DIST_TILE = (256, 256)            # the tiled composition's (i, j) tile
DIST_NB = 8                       # views a mesh batch (4 a pod)
POD_MESH = ((2, 2, 2), ("pod", "data", "model"))


def _rel_max(got, want) -> float:
    """max |got - want| / max |want|, in float64 on the card."""
    import torch
    if not isinstance(got, torch.Tensor):
        got = torch.from_numpy(got)
    got = got.to(want.device, torch.float64)
    want = want.to(torch.float64)
    return float((got - want).abs().max() / want.abs().max())


def phase_dist(seed: int, card: str) -> int:
    """The CT projection source at FORWARD_N^3 (F1 on the card, against
    its plain version) feeding the (2, 2, 2) mesh; then the mesh walks at
    DIST_PROBLEM on random views: ``distributed_backproject`` on
    ("cuda:0",) * 8 as a (2, 2, 2) pod/data/model mesh and on ("cuda:0",)
    as (1, 1, 1), and the tiled composition (``TiledReconstructor.
    backproject_distributed``) sync and async, each against the card's
    single-device ``bp_subline_symmetry_scan`` at rel-max 1e-5, async
    equal to sync bit for bit. The mesh path runs the plain ladder, no
    kernel of K1-K6. Returns the source's F1 launches."""
    import numpy as np
    import torch
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.backproject import (bp_subline_symmetry_scan,
                                              transpose_projections)
    from repro_torch.core.distributed import distributed_backproject
    from repro_torch.core.geometry import (projection_matrices,
                                           standard_geometry)
    from repro_torch.data import CTProjectionSource
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.engine import TiledReconstructor

    t_phase = time.perf_counter()
    entry = f"{DEVICE}:0"
    print(f"[dist] {card}; one card shows the mesh's correctness, not its "
          f"scaling: every entry is {entry}")
    pod = make_mesh(*POD_MESH, (entry,) * 8)
    one = make_mesh((1, 1, 1), POD_MESH[1], (entry,))

    # ---- the source: phantom -> F1 -> batches -> the mesh ----------------
    n = FORWARD_N
    geom = standard_geometry(n=n, n_det=n, n_proj=n)
    reset_launches()
    t0 = time.perf_counter()
    src = CTProjectionSource(geom, nb=DIST_NB, device=DEVICE)
    t1 = time.perf_counter()
    f1 = launches()[F1]
    require(f1 == 1 and sum(launches().values()) == 1,
            f"CTProjectionSource: launches {launches()}, want one of F1")
    vol = torch.from_numpy(src.volume).to(DEVICE)
    plain = plain_march(vol, geom, 2.0, np.arange(geom.n_proj))
    projs = torch.from_numpy(src.projections).to(DEVICE)
    r = rel_rmse(projs, plain)
    batches = list(src)
    require(r < BAR, "the source's projections disagree with F1's plain "
            "version")
    require([len(i) for _, i in batches] == [DIST_NB] * (n // DIST_NB)
            and np.array_equal(np.concatenate([i for _, i in batches]),
                               np.arange(n)), "the source's batches")
    img_t = transpose_projections(projs)
    mats = projection_matrices(geom, DEVICE)
    want = bp_subline_symmetry_scan(img_t, mats, geom.volume_shape_xyz)
    got = distributed_backproject(img_t, mats, geom, pod, nb=DIST_NB)
    e_src = _rel_max(got, want)
    print(f"[dist] CTProjectionSource at {n}^3 (Shepp-Logan, {n} views, "
          f"oversample 2): {1e3 * (t1 - t0):.1f} ms (phantom on the host, "
          f"host clock), {f1} launch of F1, vs F1's plain version rel_rmse "
          f"{r:.3e}; {len(batches)} batches of {DIST_NB}; through the "
          f"(2, 2, 2) mesh vs the single-device scan rel-max {e_src:.3e}")
    require(got.device.type == DEVICE and e_src < BAR,
            "the source's mesh back-projection disagrees with the scan")
    del vol, plain, projs, img_t, mats, want, got, src

    # ---- the mesh walks at DIST_PROBLEM ---------------------------------
    geom = get_problem(DIST_PROBLEM).geometry()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    img_t = torch.rand((geom.n_proj, geom.nw, geom.nh), generator=gen,
                       device=DEVICE)
    mats = projection_matrices(geom, DEVICE)
    walls = {}

    def run(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[label] = 1e3 * (time.perf_counter() - t)
        return out

    reset_launches()
    ref = run("single-device scan", lambda: bp_subline_symmetry_scan(
        img_t, mats, geom.volume_shape_xyz))
    checks = {}
    for label, mesh in ((f"(2, 2, 2) mesh on ('{entry}',) * 8", pod),
                        (f"(1, 1, 1) mesh on ('{entry}',)", one)):
        vol = run(label, lambda: distributed_backproject(
            img_t, mats, geom, mesh, nb=DIST_NB))
        require(vol.device.type == DEVICE and vol.device.index in (None, 0)
                and tuple(vol.shape) == geom.volume_shape_xyz,
                f"{label}: {vol.device}, {tuple(vol.shape)}")
        checks[label] = _rel_max(vol, ref)
        del vol
    eng = TiledReconstructor(geom, tile_shape=DIST_TILE + (geom.nz,),
                             nb=DIST_NB, device=DEVICE)
    tiled = run("tiled sync", lambda: eng.backproject_distributed(
        img_t, mats, pod, nb=DIST_NB))
    checks["tiled sync"] = _rel_max(tiled, ref)
    tiled_async = run("tiled async", lambda: eng.backproject_distributed(
        img_t, mats, pod, nb=DIST_NB, pipeline="async"))
    same = bool(np.array_equal(tiled, tiled_async))
    n_k = launches()
    for label, e in checks.items():
        print(f"[dist] {DIST_PROBLEM} {label}: rel-max {e:.3e} against the "
              f"single-device scan")
        require(e < BAR, f"{label} disagrees with the single-device scan")
    require(same, "the async tiled mesh walk is not bitwise equal to sync")
    require(sum(n_k.values()) == 0, f"the mesh path launched {n_k}")
    print(f"[dist] {DIST_PROBLEM} tiled {DIST_TILE} x the (2, 2, 2) mesh: "
          f"async bitwise equal to sync; no kernel of K1-K6 launched (the "
          f"mesh runs the plain ladder, as the reference runs its pure-JAX "
          f"one)")
    print(f"[dist] {DIST_PROBLEM} walls (host clock, one run each; {card}): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in walls.items()))
    print(f"[dist] phase {time.perf_counter() - t_phase:.1f} s")
    return f1


# --------------------------------------------------------------------------
# the LM families, served
# --------------------------------------------------------------------------

LM_ARCH = "qwen2.5-3b"
LM_DIMS = (36, 2048, 16, 2, 11008, 151936)   # layers, d, heads, kv, ff, V
LM_BAR = 1e-3                     # rel max-abs of the logits' max
LM_TOKENS = (2, 12)               # teacher-forced batch and length
LM_PREFILL = 8
LM_SLOTS = 4
LM_MAX_LEN = 256
LM_NEW_TOKENS = 24
LM_PROMPTS = ("The projection matrix maps", "Back-projection is",
              "Cone beam computed tomography",
              "Performance portability means", "Vectorization on CPUs",
              "The subline buffer caches")
# two waves of four and two requests, each 23 decode steps after prefill
LM_STEPS = 2 * (LM_NEW_TOKENS - 1)
MOE_ARCH = "deepseek-v2-lite-16b"
MOE_DIMS = (27, 2048, 16, 16, 1408, 102400)
MOE_CUT = 3                       # the lead dense layer and 2 MoE layers
MOE_NO_DROP_CF = 16.0             # capacity factor of the float32 checks
MOE_SUM_BAR = 1e-4                # tests/test_moe.py's expert-sum check
MOE_SUM_TOKENS = (2, 8)
# the other families at full width and cut depth: (arch, config changes)
FAMILIES = (("granite-moe-1b-a400m", dict(n_layers=2)),
            ("recurrentgemma-9b", dict(n_layers=4)),   # a unit + a trail
            ("rwkv6-3b", dict(n_layers=2)),
            ("seamless-m4t-medium", dict(n_layers=2, n_enc_layers=2)),
            ("internvl2-1b", dict(n_layers=2)))
FAMILY_SERVED = ("recurrentgemma-9b", "rwkv6-3b")
FAMILY_STEPS = 8                  # BatchedServer steps of a served family


def _lm_cfg(dtype: str, arch: str = LM_ARCH, dims=LM_DIMS, **changes):
    """``arch``'s registry config in ``dtype``, its dims checked against
    ``dims`` before ``changes`` (a cut depth, a capacity factor) apply."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if dims is not None:
        require((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                 cfg.d_ff, cfg.vocab_size) == dims, f"{arch} dims")
    if "capacity_factor" in changes:
        changes["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=changes.pop("capacity_factor"))
    return dataclasses.replace(cfg, dtype=dtype, **changes)


def _free_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _lm_batch(cfg, seed: int) -> dict:
    """LM_TOKENS tokens from the seed, with the frontend stub's input
    (the encdec family's frames, the vlm family's patches)."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    B, S = LM_TOKENS
    batch = {"tokens": torch.randint(0, cfg.vocab_size, LM_TOKENS,
                                     generator=gen, device=DEVICE)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, S, cfg.d_model), generator=gen,
                                      device=DEVICE)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(
            (B, cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
            device=DEVICE)
    return batch


def _lm_teacher_forcing(tag: str, cfg, seed: int, expect_params=None):
    """Build ``cfg`` on the card from the seed, then the teacher-forced
    forward of LM_TOKENS, a prefill of LM_PREFILL and decode steps to the
    end, each held to the forward at rel max-abs LM_BAR. Returns the
    model and its parameter count."""
    import torch
    from repro_torch.models import build_model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed, device=DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n_params = sum(p.numel() for p in model.parameters())
    require(expect_params is None or n_params == expect_params,
            f"{tag}: {n_params} parameters, want {expect_params}")
    require(all(p.device.type == DEVICE for p in model.parameters()),
            f"{tag}: a parameter is not on the card")
    batch = _lm_batch(cfg, seed)
    tokens = batch["tokens"]
    off = cfg.frontend_tokens if cfg.family == "vlm" else 0
    full, _ = model(batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    logits, cache, pos = model.prefill(
        dict(batch, tokens=tokens[:, :LM_PREFILL]), off + LM_TOKENS[1])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    errs = [float((logits[:, -1] - full[:, pos - 1]).abs().max())]
    step_ms = []
    for t in range(LM_PREFILL, LM_TOKENS[1]):
        t4 = time.perf_counter()
        logits, cache = model.decode_step(cache, tokens[:, t:t + 1], off + t)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t4))
        errs.append(float((logits[:, -1] - full[:, off + t]).abs().max()))
    scale = float(full.abs().max())
    rel = max(errs) / scale
    print(f"{tag} float32: {n_params} parameters ({4 * n_params / 1e9:.2f} "
          f"GB), drawn on the card in {1e3 * (t1 - t0):.1f} ms; forward of "
          f"{tuple(full.shape[:2])} tokens {1e3 * (t2 - t1):.1f} ms, prefill "
          f"of {LM_PREFILL} {1e3 * (t3 - t2):.1f} ms, decode steps "
          f"{', '.join(f'{m:.1f}' for m in step_ms)} ms (host clock, first "
          f"calls); prefill and {len(step_ms)} decode steps vs teacher "
          f"forcing: max abs {max(errs):.3e} of max |logit| {scale:.3e} "
          f"(rel {rel:.3e})")
    require(bool(torch.isfinite(full).all()) and rel < LM_BAR,
            f"{tag} float32 prefill/decode disagree with teacher forcing")
    del cache, full, logits
    return model, n_params


def _lm_serve(server, prompts, new_tokens: int, max_steps: int) -> dict:
    """The example's loop over byte-tokenized ``prompts``: admit while a
    slot is free, then one decode step; prefill and step walls (host
    clock, synchronized), stopping when drained or after ``max_steps``."""
    import torch
    from repro_torch.data import ByteTokenizer
    from repro_torch.launch.serve import Request
    tok = ByteTokenizer(server.cfg.vocab_size)
    pending = [Request(prompt=tok.encode(p), max_new_tokens=new_tokens)
               for p in prompts]
    done, prefill_ms, decode_ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    while (pending or any(r is not None for r in server.requests)) \
            and len(decode_ms) < max_steps:
        while pending:
            t = time.perf_counter()
            if not server.submit(pending[0]):
                break
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t))
            done.append(pending.pop(0))
        t = time.perf_counter()
        server.step()
        torch.cuda.synchronize()
        decode_ms.append(1e3 * (time.perf_counter() - t))
    return dict(done=done, prefill_ms=prefill_ms, decode_ms=decode_ms,
                wall=time.perf_counter() - t0,
                peak=torch.cuda.max_memory_allocated())


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _step_profile(server, positions) -> tuple:
    """Where a warm decode step's time goes: the aten ops it dispatches
    (host work), then its wall and the card's busy time under the
    profiler; both steps write a position past every request's, after
    serving. Returns (ops, profiled wall ms, busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        """Counts the aten ops dispatched inside it."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    toks = torch.zeros((server.slots, 1), dtype=torch.long, device=DEVICE)
    counter = OpCount()
    with counter:
        server._decode(server._cache, toks, positions[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        server._decode(server._cache, toks, positions[1])
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t)
    busy, _ = device_split(prof, {})
    return counter.n, prof_ms, busy


def _busy_text(busy: float, prof_ms: float) -> str:
    return (f"{busy:.3f} ms, idle share {1.0 - busy / prof_ms:.4f}"
            if busy > 0.0 else "not recorded (not measured)")


def _first_tokens_greedy(model, done) -> None:
    """A request's first token is its prompt's greedy next token (up to
    bf16 noise: the teacher-forced product has another shape)."""
    import numpy as np
    import torch
    for r in done:
        logits, _ = model({"tokens": torch.as_tensor(
            r.prompt.astype(np.int64), device=DEVICE)[None]})
        last = logits[0, -1]
        require(float(last.max() - last[r.out[0]])
                <= 1e-2 * float(last.abs().max()),
                "a first token is not the prompt's greedy next token")


def _serve_full(tag: str, cfg, seed: int, model=None):
    """bf16 ``BatchedServer`` at LM_SLOTS slots and LM_MAX_LEN over
    LM_PROMPTS, LM_NEW_TOKENS each: walls, tokens/s, peak memory, each
    request's first token checked. Returns (model, server, served, step
    median ms, weight bytes, cache bytes)."""
    import statistics as stats
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import build_model
    model = build_model(cfg, seed=seed, device=DEVICE) if model is None \
        else model
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    server = BatchedServer(cfg, model, slots=LM_SLOTS, max_len=LM_MAX_LEN)
    served = _lm_serve(server, LM_PROMPTS, LM_NEW_TOKENS, 4 * LM_STEPS)
    done, decode_ms = served["done"], served["decode_ms"]
    n_tok = sum(len(r.out) for r in done)
    require(len(done) == len(LM_PROMPTS) and len(decode_ms) == LM_STEPS
            and all(len(r.out) == LM_NEW_TOKENS for r in done)
            and all(0 <= t < cfg.vocab_size for r in done for t in r.out),
            f"{tag}: served {len(done)} requests in {len(decode_ms)} steps")
    _first_tokens_greedy(model, done)
    c_bytes = _tree_bytes(server._cache)
    steady = stats.median(decode_ms[1:])
    print(f"{tag} bf16 BatchedServer, {LM_SLOTS} slots, max_len "
          f"{LM_MAX_LEN}: {len(done)} requests x {LM_NEW_TOKENS} tokens in "
          f"{len(decode_ms)} decode steps, {1e3 * served['wall']:.1f} ms "
          f"(host clock), {n_tok / served['wall']:.1f} tokens/s; prefill a "
          f"request median {stats.median(served['prefill_ms']):.3f} ms "
          f"(first {served['prefill_ms'][0]:.3f}); decode step median "
          f"{steady:.3f} ms after the first ({decode_ms[0]:.3f}); peak "
          f"memory {served['peak'] / 2**30:.3f} GiB")
    return model, server, served, steady, w_bytes, c_bytes


def phase_lm(seed: int, card: str) -> None:
    """qwen2.5-3b at full width, weights from a seeded generator on the
    card: in float32, prefill of LM_PREFILL tokens then decode steps
    against the teacher-forced forward (rel max-abs LM_BAR); then in bf16,
    ``BatchedServer`` with LM_SLOTS slots over the byte-tokenized prompts,
    with prefill and decode walls, tokens/s, peak memory and the decode
    step's bound (weight and cache bytes over HBM bandwidth)."""
    from repro_torch.models.model import count_params_analytic

    t_phase = time.perf_counter()
    print(f"[lm] {LM_ARCH} at full width {LM_DIMS} (layers, d_model, heads, "
          f"kv heads, d_ff, vocab); {card}")
    cfg = _lm_cfg("float32")
    model, _ = _lm_teacher_forcing(
        "[lm]", cfg, seed, count_params_analytic(cfg) - cfg.d_model)
    del model
    _free_card()

    cfg = _lm_cfg("bfloat16")
    model, server, _, steady, w_bytes, c_bytes = _serve_full("[lm]", cfg,
                                                             seed)
    ops, prof_ms, busy = _step_profile(server, (LM_MAX_LEN - 2,
                                                LM_MAX_LEN - 1))
    bound = (w_bytes + c_bytes) / PEAK_BYTES * 1e3
    print(f"[lm] decode step bound: weights {w_bytes / 1e9:.3f} GB + cache "
          f"{c_bytes / 1e9:.4f} GB over 3.35 TB/s = {bound:.3f} ms (bytes); "
          f"the step at {bound / steady:.4f} of it")
    print(f"[lm] a warm bf16 decode step dispatches {ops} ops "
          f"({steady / ops * 1e3:.1f} us of the median step each); under "
          f"the profiler: wall {prof_ms:.3f} ms, device busy "
          + _busy_text(busy, prof_ms))
    print(f"[lm] phase {time.perf_counter() - t_phase:.1f} s")
    del server, model
    _free_card()


def _expert_sum(moe, x, top_k: int):
    """The routed layer by its definition: each token's top-k experts'
    SwiGLU outputs, weighted by their renormalized router probabilities,
    plus the shared experts; float32, token by token."""
    import torch
    from torch.nn import functional as F
    from repro_torch.models.moe import _top_k
    xt = x.reshape(-1, x.shape[-1]).to(torch.float32)
    probs = torch.softmax(xt @ moe.router.float(), dim=-1)
    sh = moe.shared
    out = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        ws, es = _top_k(probs[t], top_k)
        ws = ws / ws.sum()
        for w, e in zip(ws, es.tolist()):
            h = F.silu(xt[t] @ moe.wi_gate[e]) * (xt[t] @ moe.wi_up[e])
            out[t] += w * (h @ moe.wo[e])
        for n in range(sh.wo.shape[0]):
            h = F.silu(xt[t] @ sh.wi_gate[n]) * (xt[t] @ sh.wi_up[n])
            out[t] += h @ sh.wo[n]
    return out.reshape(x.shape)


def phase_moe(seed: int, card: str) -> None:
    """deepseek-v2-lite-16b at full width (MLA with kv_lora 512, 64
    experts top-6, 2 shared, 102400 words), weights from a seeded
    generator on the card. (a) float32 at MOE_CUT layers (the lead dense
    layer and two MoE layers) with capacity factor MOE_NO_DROP_CF, so no
    assignment drops: prefill and decode against teacher forcing (rel
    LM_BAR), and one MoE layer against the per-token sum of its top-k
    experts (rel MOE_SUM_BAR). (b) bf16 at full depth (27 layers) with
    the config's capacity factor, through ``BatchedServer`` with [lm]'s
    traffic: the decode step against the all-expert bound (the dense
    dispatch reads every expert) and the active-only bound, prefill,
    tokens/s, peak memory, ops a step, idle share, and the share of
    routed assignments the capacity dropped in the served steps."""
    import torch
    from repro_torch.models.model import count_params_analytic
    from repro_torch.models.moe import moe_mlp

    t_phase = time.perf_counter()
    print(f"[moe] {MOE_ARCH} at full width {MOE_DIMS} (layers, d_model, "
          f"heads, kv heads, d_ff expert, vocab), MLA, 64 experts top-6, 2 "
          f"shared; {card}")
    cfg = _lm_cfg("float32", MOE_ARCH, MOE_DIMS, n_layers=MOE_CUT,
                  capacity_factor=MOE_NO_DROP_CF)
    model, _ = _lm_teacher_forcing(
        "[moe]", cfg, seed, count_params_analytic(cfg) - cfg.d_model)
    moe = model.layers[0].moe
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    x = torch.randn(MOE_SUM_TOKENS + (cfg.d_model,), generator=gen,
                    device=DEVICE)
    stats = {}
    got, _ = moe_mlp(moe, x, cfg, stats=stats)
    want = _expert_sum(moe, x, cfg.moe.top_k)
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"[moe] float32 MoE layer on {MOE_SUM_TOKENS} tokens vs the "
          f"per-token sum of its top-6 experts and the shared ones: rel "
          f"{rel:.3e} (bar {MOE_SUM_BAR:g}); dropped "
          f"{int(stats['dropped'])} of {stats['assigned']} assignments")
    require(rel < MOE_SUM_BAR and int(stats["dropped"]) == 0,
            "the MoE layer disagrees with its expert sum")
    del model, moe, x, got, want
    _free_card()

    cfg = _lm_cfg("bfloat16", MOE_ARCH, MOE_DIMS)
    from repro_torch.models import build_model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed, device=DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == count_params_analytic(cfg) - cfg.d_model,
            f"[moe] {n_params} parameters at full depth")
    print(f"[moe] bf16 at full depth: {n_params} parameters (analytic "
          f"{count_params_analytic(cfg)}, less the final RMSNorm's absent "
          f"bias), drawn on the card in {time.perf_counter() - t0:.1f} s")
    model.moe_stats = {}
    model, server, served, steady, w_bytes, c_bytes = _serve_full(
        "[moe]", cfg, seed, model)
    drops, model.moe_stats = model.moe_stats, None   # the served steps'
    dropped = int(drops["dropped"])
    share = dropped / drops["assigned"]
    ops, prof_ms, busy = _step_profile(server, (LM_MAX_LEN - 2,
                                                LM_MAX_LEN - 1))
    bound = (w_bytes + c_bytes) / PEAK_BYTES * 1e3
    active = count_params_analytic(cfg, active_only=True)
    a_bound = (active * 2 + c_bytes) / PEAK_BYTES * 1e3
    print(f"[moe] decode step bound, all experts (the dense dispatch reads "
          f"every expert's weights): {w_bytes / 1e9:.3f} GB + cache "
          f"{c_bytes / 1e9:.4f} GB over 3.35 TB/s = {bound:.3f} ms, the "
          f"step at {bound / steady:.4f} of it; active only ({active} "
          f"parameters, {2 * active / 1e9:.3f} GB, what a gathered dispatch "
          f"reads) = {a_bound:.3f} ms, the step at {a_bound / steady:.4f}")
    print(f"[moe] a warm bf16 decode step dispatches {ops} ops "
          f"({steady / ops * 1e3:.1f} us of the median step each); under "
          f"the profiler: wall {prof_ms:.3f} ms, device busy "
          + _busy_text(busy, prof_ms))
    print(f"[moe] capacity factor {cfg.moe.capacity_factor}: the served "
          f"decode steps dropped {dropped} of {drops['assigned']} routed "
          f"assignments ({share:.4f})")
    print(f"[moe] phase {time.perf_counter() - t_phase:.1f} s")
    del server, model, served
    _free_card()


def phase_families(seed: int, card: str) -> None:
    """Each other family's config at full width and cut depth, float32,
    weights from the seed on the card: prefill and decode against teacher
    forcing (rel LM_BAR); recurrentgemma-9b and rwkv6-3b also serve
    FAMILY_STEPS ``BatchedServer`` steps (4 slots)."""
    import statistics as stats
    from repro_torch.launch.serve import BatchedServer

    t_phase = time.perf_counter()
    print(f"[families] full width, cut depth, float32; {card}")
    for arch, changes in FAMILIES:
        t0 = time.perf_counter()
        if arch.startswith("granite"):
            changes = dict(changes, capacity_factor=MOE_NO_DROP_CF)
        cfg = _lm_cfg("float32", arch, None, **changes)
        tag = f"[families] {arch} ({cfg.family}, {changes})"
        model, _ = _lm_teacher_forcing(tag, cfg, seed)
        if arch in FAMILY_SERVED:
            server = BatchedServer(cfg, model, slots=LM_SLOTS,
                                   max_len=LM_MAX_LEN)
            served = _lm_serve(server, LM_PROMPTS[:LM_SLOTS], LM_MAX_LEN,
                               FAMILY_STEPS)
            ms = served["decode_ms"]
            require(len(ms) == FAMILY_STEPS and all(
                len(r.out) == FAMILY_STEPS + 1 for r in served["done"]),
                f"{tag}: served {len(ms)} steps")
            print(f"{tag} BatchedServer, {LM_SLOTS} slots: {len(ms)} decode "
                  f"steps, median {stats.median(ms[1:]):.3f} ms after the "
                  f"first ({ms[0]:.3f}); prefill a request median "
                  f"{stats.median(served['prefill_ms']):.3f} ms (host clock)")
            del server, served
        del model
        _free_card()
        print(f"{tag} {time.perf_counter() - t0:.1f} s")
    print(f"[families] phase {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------
# the LM trained
# --------------------------------------------------------------------------

# (a) the flash backward at qwen2.5-3b's head shapes: (chunk, window)
TRAIN_ATTN = dict(B=2, S=256, H=16, KVH=2, D=128)
TRAIN_ATTN_CASES = ((64, None), (1024, None), (64, 100), (1024, 100))
TRAIN_ATTN_BAR = 5e-5             # tests/test_attention.py, unit-scale inputs
# (b) qwen2.5-3b at full width, TRAIN_CUT layers, float32
TRAIN_CUT = 2
TRAIN_TOKENS = (2, 256)           # batch, sequence of (b)
TRAIN_REMAT_BAR = 1e-6            # rel max-abs, per parameter
TRAIN_MICRO_BAR = 1e-4            # tests/test_train_integration.py
# (c) launch.train.train at the reference's smoke configs
TRAIN_SMOKE_STEPS = 30
TRAIN_RESUME_ATOL = 2e-5
# (d) qwen2.5-3b at full width and depth, bf16
TRAIN_FULL = (4, 256)             # batch, sequence
TRAIN_FULL_STEPS = 8
TRAIN_FULL_WARM = 2               # steps left out of the median
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16
# kernel-name keys of the profiled step's device time (cuBLAS GEMMs are
# "nvjet"/"gemm" kernels on this toolkit)
TRAIN_KERNEL_GROUPS = {"nvjet": "nvjet", "gemm": "gemm",
                       "elementwise": "elementwise", "reduce": "reduce",
                       "index": "index", "softmax": "softmax"}
# the optimizer's bytes a parameter: bf16 params read and written (4),
# bf16 grads read by the norm, the clip and the update and written by the
# clip (8), float32 m and v read and written (16)
OPT_BYTES_PER_PARAM = 26


def _grads_rel(a: dict, b: dict) -> float:
    """The largest per-parameter max-abs difference over max |b|."""
    return max(float((a[n] - b[n]).abs().max())
               / max(float(b[n].abs().max()), 1e-30) for n in b)


def _train_attention(seed: int) -> None:
    """(a) the flash backward (``attention._Flash``) in float32 against
    autograd through ``attention_ref``."""
    import torch
    from repro_torch.models.attention import attention_ref, flash_attention
    c = TRAIN_ATTN
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    q = draw(c["B"], c["S"], c["H"], c["D"])
    k = draw(c["B"], c["S"], c["KVH"], c["D"])
    v = draw(c["B"], c["S"], c["KVH"], c["D"])
    dout = draw(c["B"], c["S"], c["H"], c["D"])
    for chunk, window in TRAIN_ATTN_CASES:
        grads = []
        for fn in (flash_attention, attention_ref):
            ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
            kw = dict(causal=True, window=window)
            if fn is flash_attention:
                kw["chunk"] = chunk
            out = fn(*ins, **kw)
            grads.append(torch.autograd.grad(out, ins, dout))
        errs = [float((a - b).abs().max()) for a, b in zip(*grads)]
        print(f"[train] (a) flash backward, chunk {chunk}, window {window}: "
              f"max abs dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} "
              f"from autograd through attention_ref (bar {TRAIN_ATTN_BAR:g})")
        require(max(errs) <= TRAIN_ATTN_BAR,
                f"[train] the flash backward disagrees (chunk {chunk}, "
                f"window {window})")


def _train_float32(seed: int) -> None:
    """(b) qwen2.5-3b at full width, TRAIN_CUT layers, float32: loss and
    grads rematerialized against not, a microbatch=2 step's loss against
    the full batch's, the loss at init near ln V."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim.grad import value_and_grad

    cfg = _lm_cfg("float32", n_layers=TRAIN_CUT, remat=False)
    model = build_model(cfg, seed=seed, device=DEVICE)
    state = init_state(model, RunConfig(seed=seed))
    B, S = TRAIN_TOKENS
    batch = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                          global_batch=B, seed=seed).batch_at(0)
    tb = {k: torch.as_tensor(v, dtype=torch.int64, device=DEVICE)
          for k, v in batch.items()}
    loss, grads = value_and_grad(model.loss, state.params, tb)
    model.cfg = dataclasses.replace(cfg, remat=True)
    rloss, rgrads = value_and_grad(model.loss, state.params, tb)
    model.cfg = cfg
    rel = _grads_rel(rgrads, grads)
    lnv = math.log(cfg.vocab_size)
    print(f"[train] (b) {LM_ARCH} float32, {TRAIN_CUT} layers, {B}x{S} "
          f"tokens: loss {float(loss):.6f} at init (ln V {lnv:.4f}); "
          f"remat against none: loss {abs(float(rloss) - float(loss)):.3e}, "
          f"grads rel max-abs {rel:.3e} (bar {TRAIN_REMAT_BAR:g})")
    require(0.5 * lnv < float(loss) < 2.0 * lnv,
            "[train] the loss at init is not near ln V")
    require(abs(float(rloss) - float(loss)) <= TRAIN_REMAT_BAR
            * float(loss) and rel <= TRAIN_REMAT_BAR,
            "[train] rematerialized loss or grads differ")
    del grads, rgrads
    micro = {k: v.reshape(2, B // 2, S) for k, v in tb.items()}
    _, metrics = make_train_step(model, RunConfig(microbatch=2),
                                 total_steps=100)(state, micro)
    mrel = abs(float(metrics["loss"]) - float(loss)) / float(loss)
    print(f"[train] (b) a microbatch=2 step: loss {float(metrics['loss']):.6f}"
          f", rel {mrel:.3e} from the full batch's (bar "
          f"{TRAIN_MICRO_BAR:g}); gnorm {float(metrics['gnorm']):.4f}")
    require(mrel <= TRAIN_MICRO_BAR and all(
        math.isfinite(float(m)) for m in metrics.values()),
        "[train] the microbatched step disagrees with the full batch")
    del model, state
    _free_card()


def _train_loop(seed: int) -> None:
    """(c) ``launch.train.train`` on the card at the reference's own smoke
    configs: the loss falls over TRAIN_SMOKE_STEPS steps; 20 straight
    steps equal 10 + resume + 10. Checkpoints go to a temporary
    directory removed afterwards."""
    import tempfile
    import numpy as np
    from repro_torch.configs import RunConfig, ShapeConfig, get_smoke_config
    from repro_torch.launch.train import train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t0 = time.perf_counter()
        run = RunConfig(steps=TRAIN_SMOKE_STEPS, lr=3e-3, warmup_steps=5,
                        checkpoint_dir=os.path.join(tmp, "q"),
                        checkpoint_every=10, seed=seed)
        _, info = train(get_smoke_config(LM_ARCH), run,
                        shape=ShapeConfig("toy", "train", 32, 4), quiet=True,
                        device=DEVICE)
        first = float(np.mean(info["losses"][:5]))
        last = float(np.mean(info["losses"][-5:]))
        print(f"[train] (c) train() {LM_ARCH} smoke, {info['end_step']} "
              f"steps: loss {first:.4f} -> {last:.4f} (means of 5), median "
              f"step {1e3 * info['median_step_s']:.3f} ms (host clock), "
              f"{time.perf_counter() - t0:.1f} s")
        require(last < first - 0.05 and info["end_step"] == TRAIN_SMOKE_STEPS,
                "[train] the loss did not fall")
        cfg = get_smoke_config("stablelm-3b")
        shape = ShapeConfig("toy", "train", 16, 2)

        def run_of(name, steps):
            return RunConfig(steps=steps, lr=1e-3, checkpoint_every=10,
                             seed=3, schedule_horizon=20,
                             checkpoint_dir=os.path.join(tmp, name))

        a, _ = train(cfg, run_of("a", 20), shape=shape, quiet=True,
                     device=DEVICE)
        train(cfg, run_of("b", 10), shape=shape, quiet=True, device=DEVICE)
        b, info_b = train(cfg, run_of("b", 10), shape=shape, quiet=True,
                          device=DEVICE)
        diff = max(float((a.params[n] - b.params[n]).detach().abs().max())
                   for n in a.params)
        print(f"[train] (c) stablelm-3b smoke: 20 straight steps against 10 "
              f"+ resume + 10: max abs {diff:.3e} over the parameters (atol "
              f"{TRAIN_RESUME_ATOL:g}); resumed run ended at step "
              f"{info_b['end_step']}")
        require(diff <= TRAIN_RESUME_ATOL and info_b["end_step"] == 20,
                "[train] the resumed run differs from the straight one")
    _free_card()


def _train_full(seed: int, card: str) -> None:
    """(d) qwen2.5-3b at full width and depth in bf16, remat "nothing":
    TRAIN_FULL_STEPS ``make_train_step`` steps on ``TokenPipeline``
    batches; step ms, tokens/s, peak memory, ops a step, device busy and
    idle share, and the step's bound (8 N T FLOPs over the bf16 peak
    plus the optimizer's bytes over HBM bandwidth)."""
    import math
    import statistics as stats
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import RunConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.model import count_params_analytic

    cfg = _lm_cfg("bfloat16", remat=True, remat_policy="nothing")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=seed, device=DEVICE)
    run = RunConfig(seed=seed)
    state = init_state(model, run)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in state.params.values())
    require(n == count_params_analytic(cfg) - cfg.d_model,
            f"[train] {n} parameters at full depth")
    print(f"[train] (d) {LM_ARCH} bf16 at full depth: {n} parameters, "
          f"AdamW state {8 * n / 1e9:.2f} GB float32, built and drawn in "
          f"{time.perf_counter() - t0:.1f} s")
    B, S = TRAIN_FULL
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                         global_batch=B, seed=seed)
    step = make_train_step(model, run, total_steps=100)
    torch.cuda.reset_peak_memory_stats()
    ms, losses, gnorms = [], [], []
    for i in range(TRAIN_FULL_STEPS):
        batch = pipe.batch_at(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(x) for x in losses + gnorms),
            f"[train] a non-finite loss or gnorm: {losses} {gnorms}")
    med = stats.median(ms[TRAIN_FULL_WARM:])
    tokens = B * S
    print(f"[train] (d) {TRAIN_FULL_STEPS} steps of {B}x{S} tokens: losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; gnorms "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}")
    print(f"[train] (d) step ms {', '.join(f'{x:.1f}' for x in ms)} (host "
          f"clock, synchronized); median after the first "
          f"{TRAIN_FULL_WARM}: {med:.3f} ms, {tokens / med * 1e3:.1f} "
          f"tokens/s; peak memory {peak / 2**30:.3f} GiB")

    class OpCount(TorchDispatchMode):
        """Counts the aten ops dispatched inside it (backward's too)."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    counter = OpCount()
    with counter:
        state, _ = step(state, pipe.batch_at(TRAIN_FULL_STEPS))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, _ = step(state, pipe.batch_at(TRAIN_FULL_STEPS + 1))
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t)
    busy, split = device_split(prof, TRAIN_KERNEL_GROUPS)
    flops = 8.0 * n * tokens
    t_flops = flops / PEAK_BF16_FLOPS * 1e3
    opt_bytes = OPT_BYTES_PER_PARAM * n
    t_bytes = opt_bytes / PEAK_BYTES * 1e3
    bound = t_flops + t_bytes
    print(f"[train] (d) step bound: 8 x {n} parameters x {tokens} tokens = "
          f"{flops:.4e} FLOP (forward, remat recompute, backward) over 989 "
          f"TFLOP/s bf16 = {t_flops:.3f} ms, plus the optimizer's "
          f"{OPT_BYTES_PER_PARAM} B a parameter = {opt_bytes / 1e9:.3f} GB "
          f"over 3.35 TB/s = {t_bytes:.3f} ms: {bound:.3f} ms; the step at "
          f"{bound / med:.4f} of it")
    us_op = med / counter.n * 1e3
    print(f"[train] (d) a step dispatches {counter.n} ops ({us_op:.1f} us "
          f"of the median step each); under the profiler: "
          f"wall {prof_ms:.3f} ms, device busy " + _busy_text(busy, prof_ms)
          + f"; {card}")
    print("[train] (d) device ms of the profiled step by kernel name: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f", the rest {busy - sum(split.values()):.3f} (of busy; the "
          f"groups may overlap in time)")
    del state, model, step, prof
    _free_card()


def phase_train(seed: int, card: str) -> None:
    """The LM trained on the card: (a) the flash backward against
    autograd through the oracle at qwen2.5-3b's head shapes; (b)
    qwen2.5-3b at full width, cut depth, float32 (remat, microbatches,
    the loss at init); (c) ``launch.train.train`` at the smoke configs
    (the loss falls, a resume equals a straight run); (d) qwen2.5-3b at
    full width and depth in bf16, timed against its bound. No kernel of
    K1-K6 or F1 lies on this path."""
    t_phase = time.perf_counter()
    print(f"[train] {LM_ARCH} at full width {LM_DIMS}; {card}")
    before = launches()
    _train_attention(seed)
    _train_float32(seed)
    _train_loop(seed)
    _train_full(seed, card)
    n = sum(c - before.get(k, 0) for k, c in launches().items())
    print(f"[train] kernel launches of K1-K6 and F1 in the phase: {n}")
    require(n == 0, "[train] a CT kernel launched in the training phase")
    print(f"[train] phase {time.perf_counter() - t_phase:.1f} s")


# the LM's parallel layer: in-process meshes whose every entry is the card
SHARD_RESHARD = (((4, 2), ("data", "model")), ((2, 4), ("data", "model")))
SHARD_MESH = ((2, 2), ("data", "model"))
SHARD_STEP_BAR = 1e-4             # tests/test_distributed.py's bar
SHARD_DECODE_BAR = 1e-5           # rel max-abs of the logits' max
SHARD_DECODE_STEPS = 4            # float32 decode steps after the prefill
SHARD_FULL_STEPS = 3
SHARD_PSUM = ((4, 2), ("data", "model"), (1024, 1024))  # mesh, member shape
SHARD_PSUM_AMAX = 3.0             # every member's planted max |g|
SHARD_DRYRUN = ("qwen2.5-3b", "decode_32k")


def _shard_mesh(shape_names):
    from repro_torch.launch.mesh import make_mesh
    shape, names = shape_names
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, names, devices=("cuda:0",) * n)


def _shard_reshard(seed: int) -> None:
    """(a) a round trip of full-width parameters between two meshes."""
    import torch
    from repro_torch.launch import sharding as shd
    from repro_torch.models import build_model
    from repro_torch.runtime import reshard_tree

    cfg = _lm_cfg("float32", n_layers=TRAIN_CUT)
    model = build_model(cfg, seed=seed, device=DEVICE)
    tree = {n: p.detach() for n, p in model.named_parameters()}
    mesh_a, mesh_b = (_shard_mesh(m) for m in SHARD_RESHARD)

    def spec_fn(mesh):
        return lambda path, leaf: shd.spec_for_param(path, leaf.shape, mesh)

    t0 = time.perf_counter()
    t_a = reshard_tree(tree, mesh_a, spec_fn(mesh_a))
    t_b = reshard_tree(t_a, mesh_b, spec_fn(mesh_b))
    back = reshard_tree(t_b, mesh_a, spec_fn(mesh_a))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    exact = all(torch.equal(back[n].full(), t) and torch.equal(
        t_b[n].full(), t) for n, t in tree.items())
    blocks = all(torch.equal(b, t[st.sharding.block_slices(t.shape, e)])
                 and b.device == mesh_b.devices[e]
                 for n, t in tree.items() for st in (t_b[n],)
                 for e, b in enumerate(st.blocks))
    named = sum("model" in tuple(st.spec) for st in t_b.values())
    print(f"[shard] (a) reshard_tree {cfg.name} (full width, {TRAIN_CUT} "
          f"layers, float32, {len(tree)} tensors): {SHARD_RESHARD[0][0]} -> "
          f"{SHARD_RESHARD[1][0]} -> {SHARD_RESHARD[0][0]} on cuda:0 x 8 in "
          f"{ms:.1f} ms (host clock); round trip bit for bit: {exact}; "
          f"every entry holds its spec's block: {blocks}; {named} tensors "
          f"name 'model' on the second mesh")
    require(exact and blocks and named > 0, "[shard] the reshard round "
            "trip differs")
    del t_a, t_b, back, tree, model
    _free_card()


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _shard_train_float32(seed: int) -> None:
    """(b) two sharded steps against two unsharded ones, float32."""
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import (init_state, make_train_step,
                                          shard_train_step)
    from repro_torch.models import build_model
    from repro_torch.models.model import abstract_params

    cfg = _lm_cfg("float32", n_layers=TRAIN_CUT, remat=False)
    model = build_model(cfg, seed=seed, device=DEVICE)
    run = RunConfig(seed=seed, warmup_steps=0)
    B, S = TRAIN_FULL
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                         global_batch=B, seed=seed)
    step = make_train_step(model, run, total_steps=100)
    mesh = _shard_mesh(SHARD_MESH)
    sstep, _ = shard_train_step(step, model, mesh, abstract_params(cfg),
                                pipe.batch_at(0))
    sharded, state = [], init_state(model, run)
    for i in range(2):
        state, m = sstep(state, pipe.batch_at(i))
        sharded.append((float(m["loss"]), float(m["gnorm"])))
    params = {n: st.full() for n, st in state.params.items()}
    del state
    plain, state = [], init_state(model, run)
    for i in range(2):
        state, m = step(state, pipe.batch_at(i))
        plain.append((float(m["loss"]), float(m["gnorm"])))
    prel = max(float((params[n] - p.detach()).abs().max())
               / max(float(p.detach().abs().max()), 1e-30)
               for n, p in state.params.items())
    for i, ((sl, sg), (ul, ug)) in enumerate(zip(sharded, plain)):
        print(f"[shard] (b) {LM_ARCH} float32, {TRAIN_CUT} layers, {B}x{S} "
              f"tokens, mesh {SHARD_MESH[0]}: step {i + 1} loss {sl:.6f} / "
              f"unsharded {ul:.6f} (rel {_rel(sl, ul):.3e}), gnorm "
              f"{sg:.6f} / {ug:.6f} (rel {_rel(sg, ug):.3e}); bar "
              f"{SHARD_STEP_BAR:g}")
        require(_rel(sl, ul) <= SHARD_STEP_BAR
                and _rel(sg, ug) <= SHARD_STEP_BAR,
                f"[shard] sharded step {i + 1} disagrees")
    print(f"[shard] (b) parameters after 2 steps: rel max-abs {prel:.3e} "
          f"from the unsharded ones (AdamW's m / sqrt(v) amplifies the "
          f"gradients' summation order where they are near 0)")
    del state, model, params
    _free_card()


def _shard_train_full(seed: int, card: str) -> None:
    """(c) qwen2.5-3b bf16 at full width and depth, sharded and not."""
    import math
    import statistics as stats
    import torch
    from repro_torch.configs import RunConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import hlo_cost
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.train import (init_state, make_train_step,
                                          shard_state, shard_train_step)
    from repro_torch.models import build_model
    from repro_torch.models.model import abstract_params

    cfg = _lm_cfg("bfloat16", remat=True, remat_policy="nothing")
    model = build_model(cfg, seed=seed, device=DEVICE)
    run = RunConfig(seed=seed, warmup_steps=0)
    B, S = TRAIN_FULL
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=S,
                         global_batch=B, seed=seed)
    step = make_train_step(model, run, total_steps=100)
    mesh = _shard_mesh(SHARD_MESH)
    sstep, shardings = shard_train_step(step, model, mesh,
                                        abstract_params(cfg),
                                        pipe.batch_at(0))
    n = sum(p.numel() for p in model.parameters())
    state = shard_state(init_state(model, run), shardings, donate=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, sharded = [], []
    for i in range(SHARD_FULL_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = sstep(state, pipe.batch_at(i))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        sharded.append((float(m["loss"]), float(m["gnorm"])))
    peak = torch.cuda.max_memory_allocated()
    per_entry = shd.entry_bytes([state.params, state.opt.m, state.opt.v],
                                mesh)
    total = sum(p.numel() * p.element_size() for p in model.parameters()) \
        + 8 * n
    entries = len(mesh.devices)
    counter = hlo_cost.OpCounter()
    with counter:
        state, _ = sstep(state, pipe.batch_at(SHARD_FULL_STEPS))
    torch.cuda.synchronize()
    flops = hlo_cost.analyze(counter.log())["flops"]
    del state
    _free_card()
    plain, state = [], init_state(model, run)
    for i in range(SHARD_FULL_STEPS):
        state, m = step(state, pipe.batch_at(i))
        plain.append((float(m["loss"]), float(m["gnorm"])))
    del state
    require(all(math.isfinite(x) for pair in sharded + plain for x in pair),
            f"[shard] a non-finite loss: {sharded} {plain}")
    med = stats.median(ms[1:])
    tokens = B * S
    print(f"[shard] (c) {LM_ARCH} bf16 at full depth ({n} parameters, remat "
          f"'nothing'), {B}x{S} tokens, mesh {SHARD_MESH[0]} on cuda:0 x "
          f"{entries}: losses "
          + ", ".join(f"{a:.4f} / {b:.4f}" for (a, _), (b, _)
                      in zip(sharded, plain))
          + " (sharded / unsharded); gnorms "
          + ", ".join(f"{a:.4f} / {b:.4f}" for (_, a), (_, b)
                      in zip(sharded, plain)))
    print(f"[shard] (c) sharded step ms {', '.join(f'{x:.1f}' for x in ms)} "
          f"(host clock, synchronized); median after the first {med:.3f} "
          f"ms, {tokens / med * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.3f} GiB; {card}")
    print(f"[shard] (c) state bytes (parameter, m and v blocks) by entry: "
          f"{', '.join(f'{b / 1e9:.3f}' for b in per_entry)} GB against "
          f"total / entries {total / entries / 1e9:.3f} GB (total "
          f"{total / 1e9:.3f} GB)")
    print(f"[shard] (c) a sharded step's counted FLOPs {flops:.4e} against "
          f"8 N T = {8.0 * n * tokens:.4e} ({flops / (8.0 * n * tokens):.4f}"
          f" of it; {counter.n_ops} ops dispatched)")
    require(peak < 80 * 10**9, "[shard] the sharded step does not fit")
    del model, step, sstep
    _free_card()


def _shard_decode(seed: int, card: str) -> None:
    """(d) the sharded decode step: float32 logits, bf16 served."""
    import statistics as stats
    import torch
    from repro_torch.launch.serve import (BatchedServer, make_decode_fn,
                                          shard_decode_step)
    from repro_torch.models import build_model
    from repro_torch.models.model import abstract_params

    mesh = _shard_mesh(SHARD_MESH)
    cfg = _lm_cfg("float32", n_layers=TRAIN_CUT)
    model = build_model(cfg, seed=seed, device=DEVICE)
    B, S = LM_TOKENS
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + SHARD_DECODE_STEPS),
                           generator=gen, device=DEVICE)
    max_len = S + SHARD_DECODE_STEPS
    fn, _, cspecs = shard_decode_step(model, mesh, abstract_params(cfg), B,
                                      max_len)
    _, cache, pos = model.prefill({"tokens": tokens[:, :S]}, max_len)
    _, ucache, _ = model.prefill({"tokens": tokens[:, :S]}, max_len)
    plain = make_decode_fn(model)
    worst = 0.0
    for i in range(SHARD_DECODE_STEPS):
        tok = tokens[:, S + i:S + i + 1]
        got, cache = fn(cache, tok, pos + i)
        want, ucache = plain(ucache, tok, pos + i)
        worst = max(worst, float((got - want).abs().max())
                    / float(want.abs().max()))
    print(f"[shard] (d) shard_decode_step {LM_ARCH} float32, {TRAIN_CUT} "
          f"layers, batch {B}, mesh {SHARD_MESH[0]}, cache specs "
          f"{ {k: tuple(v) for k, v in cspecs.items()} }: "
          f"{SHARD_DECODE_STEPS} steps, logits rel max-abs {worst:.3e} "
          f"from the unsharded step (bar {SHARD_DECODE_BAR:g})")
    require(worst <= SHARD_DECODE_BAR, "[shard] sharded decode disagrees")
    del model, cache, ucache, fn
    _free_card()

    cfg = _lm_cfg("bfloat16")
    model = build_model(cfg, seed=seed, device=DEVICE)
    out = {}
    for tag in ("unsharded", "sharded"):
        server = BatchedServer(cfg, model, slots=LM_SLOTS,
                               max_len=LM_MAX_LEN)
        if tag == "sharded":
            server._decode = shard_decode_step(
                model, mesh, abstract_params(cfg), LM_SLOTS, LM_MAX_LEN)[0]
        served = _lm_serve(server, LM_PROMPTS, LM_NEW_TOKENS, 4 * LM_STEPS)
        require(len(served["done"]) == len(LM_PROMPTS) and all(
            len(r.out) == LM_NEW_TOKENS for r in served["done"]),
            f"[shard] {tag} serving did not finish")
        out[tag] = served
    pairs = [(a, b) for ra, rb in zip(out["unsharded"]["done"],
                                      out["sharded"]["done"])
             for a, b in zip(ra.out, rb.out)]
    same = sum(a == b for a, b in pairs)
    print(f"[shard] (d) {LM_ARCH} bf16 at full width, BatchedServer "
          f"{LM_SLOTS} slots, max_len {LM_MAX_LEN}, decoding through "
          f"shard_decode_step on {SHARD_MESH[0]}: step median "
          f"{stats.median(out['sharded']['decode_ms'][1:]):.3f} ms against "
          f"{stats.median(out['unsharded']['decode_ms'][1:]):.3f} unsharded "
          f"(host clock); tokens equal to the unsharded server's: {same} "
          f"of {len(pairs)}; peak memory "
          f"{out['sharded']['peak'] / 2**30:.3f} GiB; {card}")
    del model, out
    _free_card()


def _shard_psum(seed: int) -> None:
    """(e) the int8 all-reduce over the data axis, against the plain
    sum."""
    import torch
    from repro_torch.launch import sharding as shd
    from repro_torch.optim.grad import compressed_psum

    mesh = _shard_mesh(SHARD_PSUM[:2])
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    g = {}
    for e in range(len(mesh.devices)):
        t = torch.randn(SHARD_PSUM[2], generator=gen, device=DEVICE)
        t = t.clamp(-SHARD_PSUM_AMAX, SHARD_PSUM_AMAX)
        t.view(-1)[e] = SHARD_PSUM_AMAX        # every member's max |g|
        g[e] = t
    total, _ = compressed_psum(g, mesh, "data")
    n = mesh.axis_size("data")
    scale = SHARD_PSUM_AMAX / 127.0
    worst = 0.0
    for e in range(len(mesh.devices)):
        members = shd.group(mesh, e, [a for a in mesh.axis_names
                                      if a != "data"])
        want = sum(g[m].double() for m in members)
        worst = max(worst, float((total[e].double() - want).abs().max()))
    bound = n * scale / 2 * (1 + 1e-5)
    print(f"[shard] (e) compressed_psum over 'data' of {SHARD_PSUM[0]}, "
          f"members {SHARD_PSUM[2]} float32 with max |g| {SHARD_PSUM_AMAX}: "
          f"max abs {worst:.4e} from the plain sum, bound n x scale / 2 = "
          f"{n * scale / 2:.4e}")
    require(worst <= bound, "[shard] compressed_psum exceeds its int8 bound")


def _shard_dryrun() -> None:
    """(f) one dry-run cell on the abstract production mesh."""
    import tempfile
    from repro_torch.launch import dryrun, roofline

    arch, shape = SHARD_DRYRUN
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        rec = dryrun.run_cell(arch, shape, multi_pod=False, out_dir=tmp,
                              verbose=False)
        require(rec["status"] == "ok", f"[shard] dry run: {rec.get('error')}")
        require(dryrun.reanalyze(tmp) == 1, "[shard] reanalyze")
        rows = [roofline.terms_for(r) for r in roofline.load_dir(tmp)]
    print(f"[shard] (f) dry run {arch} x {shape} on the abstract (16, 16) "
          f"mesh in {rec['run_s']} s, {rec['ops_dispatched']} ops: "
          + json.dumps({k: rec[k] for k in ("memory", "cost",
                                            "collectives")}))
    print("[shard] (f) roofline (H100 SXM constants):\n"
          + roofline.markdown_table(rows).rstrip())


def phase_shard(seed: int, card: str) -> None:
    """The LM's parallel layer and dry run on the card: (a) reshard, (b)
    the float32 sharded train step, (c) the bf16 one at full width, (d)
    the sharded decode step, (e) the int8 all-reduce, (f) a dry-run cell.
    No kernel of K1-K6 or F1 lies on this path."""
    t_phase = time.perf_counter()
    print(f"[shard] {LM_ARCH} on in-process meshes of the one card; {card}")
    before = launches()
    _shard_reshard(seed)
    _shard_train_float32(seed)
    _shard_train_full(seed, card)
    _shard_decode(seed, card)
    _shard_psum(seed)
    _shard_dryrun()
    n = sum(c - before.get(k, 0) for k, c in launches().items())
    print(f"[shard] kernel launches of K1-K6 and F1 in the phase: {n}")
    require(n == 0, "[shard] a CT kernel launched in the parallel phase")
    print(f"[shard] phase {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # read when telemetry is imported: [trace]'s spans open
    # record_function ranges (spans exist only while tracing is on)
    os.environ["REPRO_TRACE_NVTX"] = "1"
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    phase_plan(PLAN_SHAPES)
    errs = phase_kernels_sweep(args.seed)
    # the solvers first: later in a long process torch.profiler lost the
    # device records of whole kernels (found on the card; cause not
    # known), and their profile is the one that splits the time by kernel
    f1_row = phase_solve(args.seed)
    rows = phase_p5(args.seed, errs)
    rows[F1] = f1_row
    # right after P5: the profiler lost device records late in a process
    phase_trace(args.seed)
    plain, plans = PlainCalls(), PlanLog()
    walls = phase_tiled_p5(args.seed, plain, plans)
    profile_tiled(args.seed, walls)
    phase_forward()
    tune = phase_tune(args.seed)
    for name, row in rows.items():
        # the batch axis's candidates launch the lane forms
        row["launches_tune"] = tune[name] + tune.get(f"{name}_lanes", 0)
    # request batching, streaming and serving: the lane launches of their
    # main-path runs join each row as launches_batch
    batch, lane_ms = phase_batch(args.seed, errs, plain)
    stream = phase_stream(args.seed, plain)
    service = phase_service(args.seed, plain)
    # the fleet: its checked runs' launches join each row as launches_fleet
    fleet = phase_fleet(args.seed, plain, walls)
    # mesh-sharded back-projection (the plain ladder) and the CT projection
    # source, whose F1 launches join F1's row; then the dense LM served.
    # After every earlier phase, which keep the process state they had
    rows[F1]["launches_source"] = phase_dist(args.seed, card)
    phase_lm(args.seed, card)
    # the other LM families: the MoE/MLA model served, then the rest
    phase_moe(args.seed, card)
    phase_families(args.seed, card)
    # the LM trained: no kernel of its own (the reference's training path
    # reaches no pl.pallas_call)
    phase_train(args.seed, card)
    # the LM's parallel layer and the dry run: no kernel of its own either
    phase_shard(args.seed, card)
    for name, row in rows.items():
        row["launches_batch"] = (batch.get(name, 0) + stream.get(name, 0)
                                 + service.get(name, 0))
        row["lane_ms"] = lane_ms.get(name)
        row["launches_fleet"] = fleet.get(name, 0)
        if name in errs:
            row["max_abs_err"] = max(row["max_abs_err"], errs[name])
    # last: after P10's host walks the profiler recorded no device time at
    # all, so every profile runs before them
    plans.report()
    phase_tiled_p10(args.seed, plain, plans)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
